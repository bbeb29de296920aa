"""K3's layout, launch rule and per-block algorithm on the CPU.

`k3_smem`, `k3_launch`, `k3_pad`, `k3_chains` and `k3_ops`
(ops/bitsliced) are the host's mirrors of csrc/gf_encode_crc_acc.cu:
pure functions of the shapes, checked here over every accepted shape.
`k3_model` is a numpy model of the kernel's per-block algorithm on the
same operands the kernel receives — the packed parity's nibble tables
and the 4x4 byte transpose, the lane-copied crc table, the staged rows with
their pads, the interleaved crc chains and their chain operators, the
per-lane fold operators and the base-256 advance tables of `k3_ops`,
the run search, the XOR of every block into its run's slot, the grid
walk of `k3_launch` — held bit-exact against Pallas kernel #4 in
interpret mode (as tests/test_torch_acc.py reaches it) and against K3's
plain version.  The kernel itself is held against its plain version on
the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as jgf
from ceph_tpu.ops import bitsliced as jbs
from ceph_tpu.ops import crc32c_linear as jcl
from ceph_tpu_torch.common import crc32c as tcrc
from ceph_tpu_torch.ec import gf as tgf
from ceph_tpu_torch.ops import bitsliced as bs

H100_SMS = 132
CPU = torch.device("cpu")
SENTINEL = np.uint32(0xA5A5A5A5)     # what the pads and unstaged words hold


def _transpose4(a: np.ndarray) -> np.ndarray:
    """gf_common.cuh transpose4 over the last axis (4 uint32): byte t of
    a[b] becomes byte b of a[t]."""
    sh = (8 * np.arange(4)).astype(np.uint32)
    byte = (a[..., :, None] >> sh) & np.uint32(0xFF)       # [b, t]
    return np.bitwise_or.reduce(np.swapaxes(byte, -1, -2) << sh, axis=-1)


def _nibble_packed(tables: np.ndarray) -> np.ndarray:
    """(groups, k, 32) uint32 nibble tables of the packed parity, as
    build_nibble_packed writes them: entry 16*h + v of (g, j) has byte t
    = C[4g+t][j] * (v << 4h), 0 past the last row."""
    m, k, _ = tables.shape
    groups = -(-m // 4)
    rows = np.zeros((4 * groups, k, 256), dtype=np.uint32)
    rows[:m] = tables
    x = np.concatenate([np.arange(16), np.arange(16) << 4])
    sel = rows[:, :, x].reshape(groups, 4, k, 32)          # [g, t, j, e]
    sh = (8 * np.arange(4, dtype=np.uint32))[None, :, None, None]
    return np.bitwise_or.reduce(sel << sh, axis=1)


def _nibbles(cols: np.ndarray) -> np.ndarray:
    """Nibble tables of operators given as 32 columns (last axis):
    [..., i, v] = XOR of columns 4i .. 4i+3 that v selects."""
    c = cols.reshape(*cols.shape[:-1], 8, 4)
    v = np.arange(16)
    bits = ((v[:, None] >> np.arange(4)) & 1).astype(np.uint32)   # [v, b]
    return np.bitwise_xor.reduce(c[..., None, :] * bits, axis=-1)


def _nibble(x: np.ndarray, i: int) -> np.ndarray:
    return ((x >> np.uint32(4 * i)) & np.uint32(15)).astype(np.int64)


def _apply_nibbles(nib: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One operator's nibble tables nib (8, 16) applied to every x."""
    return np.bitwise_xor.reduce([nib[i, _nibble(x, i)] for i in range(8)],
                                 axis=0)


def _apply_lane_nibbles(nib: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Lane l's operator (nib (32, 8, 16)) applied to x[..., l]."""
    lanes = np.arange(32)
    return np.bitwise_xor.reduce([nib[lanes, i, _nibble(x, i)]
                                  for i in range(8)], axis=0)


def _lane_crc_table() -> np.ndarray:
    """The lane tables as build_lane_crc_table writes them: each warp
    computes entry e0 + lane, then word 32*(e0+i) + lane takes lane i's
    entry (a shuffle)."""
    ltab = np.full(256 * 32, SENTINEL, dtype=np.uint32)
    for e0 in range(0, 256, 32):
        c = np.arange(e0, e0 + 32, dtype=np.uint32)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (np.uint32(0x82F63B78) *
                                       (c & np.uint32(1)))
        for i in range(32):
            ltab[(e0 + i) * 32 + np.arange(32)] = c[i]
    return ltab


def _apply_cols(cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """XOR_b cols[..., b] where bit b of x is set (one thread's matvec)."""
    bits = (x[..., None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return np.bitwise_xor.reduce(cols * bits, axis=-1)


def k3_model(tables: np.ndarray, chunks: np.ndarray, run_ends: np.ndarray,
             block: int, sm_count: int = H100_SMS):
    """K3's algorithm, block by block, on the kernel's operands; returns
    (parity (m, n) uint8, L (nruns, k+m) int64)."""
    m, k, _ = tables.shape
    n = chunks.shape[1]
    r_tot = k + m
    W, wpp, pad = block // 4, block // 128, bs.k3_pad(block)
    S = W + 32 * pad
    groups = -(-m // 4)
    T = _nibble_packed(tables)
    ltab = _lane_crc_table()
    ops = bs.k3_ops(block)
    fold = _nibbles(ops[:1024].reshape(32, 32).T)      # [lane, i, v]
    cnib = _nibbles(ops[1024:bs.K3_OP_COLS].reshape(bs.K3_MAX_CHAINS - 1,
                                                    32))
    digits = ops[bs.K3_OP_COLS:].reshape(bs.K3_DIGITS, 256, 32)
    chains = bs.k3_chains(block)
    wpc = wpp // chains
    words = np.ascontiguousarray(chunks).view("<u4")   # (k, n/4)
    pw = np.arange(W) + (np.arange(W) // wpp) * pad    # staged word index
    lanes = np.arange(32)
    piece_idx = lanes[:, None] * (wpp + pad) + np.arange(wpp)[None, :]
    parity = np.zeros((m, n // 4), dtype=np.uint32)
    lacc = np.zeros((len(run_ends), r_tot), dtype=np.uint64)
    ntiles = n // block
    grid = bs.k3_launch(n, block, k, m, sm_count)
    for b in range(grid):
        for tile in range(b, ntiles, grid):
            rows = np.full((r_tot, S), SENTINEL, dtype=np.uint32)
            rows[:k, pw] = words[:, tile * W:(tile + 1) * W]
            x = rows[:k, pw]                                       # (k, W)
            for g in range(groups):
                acc = np.zeros((W, 4), dtype=np.uint32)
                for j in range(k):
                    for byte in range(4):
                        lo = _nibble(x[j], 2 * byte)
                        hi = _nibble(x[j], 2 * byte + 1)
                        acc[:, byte] ^= T[g, j, lo] ^ T[g, j, 16 + hi]
                acc = _transpose4(acc)
                for t in range(min(4, m - 4 * g)):
                    rows[k + 4 * g + t, pw] = acc[:, t]
                    parity[4 * g + t, tile * W:(tile + 1) * W] = acc[:, t]
            run = int(np.searchsorted(run_ends, tile, side="right"))
            dist = int(run_ends[run]) - 1 - tile
            # each lane: `chains` chains over consecutive sub-pieces,
            # the word XORed in first, then joined by the chain operators
            crc = np.zeros((chains, r_tot, 32), dtype=np.uint32)
            for t in range(wpc):
                for c in range(chains):
                    x = rows[:, piece_idx[:, c * wpc + t]] ^ crc[c]
                    for _ in range(4):
                        x = ltab[((x & np.uint32(0xFF)) << np.uint32(5))
                                 + lanes] ^ (x >> np.uint32(8))
                    crc[c] = x
            lane_l = crc[chains - 1].copy()
            for c in range(chains - 1):
                lane_l ^= _apply_nibbles(cnib[chains - 2 - c], crc[c])
            lval = np.bitwise_xor.reduce(_apply_lane_nibbles(fold, lane_l),
                                         axis=1)
            for i in range(bs.K3_DIGITS):
                c = (dist >> (8 * i)) & 255
                if c:
                    lval = _apply_cols(digits[i, c], lval)
            lacc[run] ^= lval.astype(np.uint64)
    return parity.view(np.uint8).reshape(m, n), lacc.astype(np.int64)


def _tables(mat):
    return tgf.product_tables(mat)


# ----------------------------------------------------------------------------
# the pure mirrors
# ----------------------------------------------------------------------------

BLOCKS = (128, 256, 384, 512, 1024, 2048, 4096, 8192)


def _smem_formula(m, k, block):
    pad = 2 if (block // 128) % 2 else 1
    return 4 * (-(-m // 4) * k * 32 + 8192 + 4480
                + (k + m) * (block // 4 + 32 * pad)) + 16


@pytest.mark.parametrize("block", BLOCKS)
def test_k3_smem_accepts_exactly_the_shapes_within_the_limit(block):
    """Every (k, m) whose layout fits one block's 227 KB is accepted with
    the layout's exact size; the next k past the limit raises."""
    for m in range(1, 33):
        k = 1
        while _smem_formula(m, k, block) <= bs.SMEM_LIMIT:
            assert bs.k3_smem(m, k, block) == _smem_formula(m, k, block)
            k += 1
        with pytest.raises(ValueError, match="shared memory"):
            bs.k3_smem(m, k, block)


def test_k3_smem_main_shapes_and_edges():
    """The write path's 8+3 at the autotuner's blocks, the card tests'
    10+4 and 8+6, and the CPU tests' 512-byte block; blocks that are no
    multiple of 128 raise."""
    assert bs.k3_smem(3, 8, 2048) == 75664     # 1+32+17.5+23.4 KiB + 16 B
    for wb in (256, 512, 1024):                # autotune.SWEEP_WBS
        for k, m in ((8, 3), (10, 4), (8, 6), (4, 2)):
            assert bs.k3_smem(m, k, 4 * wb) <= bs.SMEM_LIMIT
    assert bs.k3_smem(2, 4, 512) == 4 * (4 * 32 + 8192 + 4480 + 6 * 160) + 16
    for bad in (0, 64, 200, -128):
        with pytest.raises(ValueError, match="multiple of 128"):
            bs.k3_smem(3, 8, bad)


@pytest.mark.parametrize("block", BLOCKS)
def test_k3_pad_puts_every_lane_in_its_own_bank(block):
    """The staged word index w + (w // wpp) * pad is one-to-one and within
    the row, and the 32 lanes' word t of their pieces sit in 32
    distinct banks for every t."""
    W, wpp, pad = block // 4, block // 128, bs.k3_pad(block)
    S = W + 32 * pad
    idx = np.arange(W) + (np.arange(W) // wpp) * pad
    assert len(set(idx.tolist())) == W and idx.max() < S
    lanes = np.arange(32)
    for t in range(wpp):
        addr = lanes * (wpp + pad) + t
        np.testing.assert_array_equal(addr, idx[lanes * wpp + t])
        assert len(set((addr % 32).tolist())) == 32


@pytest.mark.parametrize("k,m,block", [(8, 3, 2048), (8, 3, 4096),
                                       (10, 4, 1024), (4, 2, 512),
                                       (8, 6, 2048)])
def test_k3_launch_covers_every_tile_once_in_one_wave(k, m, block):
    """The grid is min(tiles, one wave); its stride walk takes every tile
    exactly once; the wave is what the launch bounds, the threads and
    the shared memory keep resident."""
    smem = bs.k3_smem(m, k, block) + bs.BLOCK_SMEM_RESERVED
    per_sm = min(bs.K3_BLOCKS_PER_SM, 2048 // bs.K3_THREADS,
                 bs.SM_SMEM // smem)
    assert per_sm >= 1
    for sms in (1, 3, H100_SMS):
        for tiles in (1, 2, 5, 255, 256, 407, 2049):
            blocks = bs.k3_launch(tiles * block, block, k, m, sms)
            assert blocks == min(tiles, per_sm * sms)
            seen = np.zeros(tiles, dtype=np.int64)
            for b in range(blocks):
                seen[b::blocks] += 1
            assert (seen == 1).all()

def test_k3_launch_main_path():
    """A 512 KiB run in 2 KiB blocks is one block a tile on the H100
    (three resident an SM); the two-run row's 407 tiles take one wave of
    396 blocks."""
    assert bs.k3_launch(512 << 10, 2048, 8, 3, H100_SMS) == 256
    assert bs.k3_launch(407 * 2048, 2048, 8, 3, H100_SMS) == 396


def test_k3_chains_divide_the_piece():
    """4, 2 or 1 chains, each over a whole number of words of the
    lane's piece."""
    for block in range(128, 16385, 128):
        c = bs.k3_chains(block)
        assert c in (1, 2, 4) and (block // 128) % c == 0
        assert c == 4 or (block // 128) % (2 * c)
    assert [bs.k3_chains(b) for b in (512, 1024, 2048, 4096, 256, 384)] \
        == [4, 4, 4, 4, 2, 1]


def test_k3_ops_are_the_fold_and_advance_operators():
    """Lane l's fold operator advances over (B/32)*(31-l) zero bytes,
    chain operator j over j sub-pieces of B/32/chains bytes, table i's
    operator c over B * c * 256^i; all as crc32c_zeros."""
    rng = np.random.default_rng(61)
    for block in (256, 512, 2048):
        ops = bs.k3_ops(block)
        assert ops.dtype == np.uint32
        assert ops.shape == (bs.K3_OP_COLS + bs.K3_DIGITS * 256 * 32,)
        fold = ops[:1024].reshape(32, 32).T
        cops = ops[1024:bs.K3_OP_COLS].reshape(bs.K3_MAX_CHAINS - 1, 32)
        digits = ops[bs.K3_OP_COLS:].reshape(bs.K3_DIGITS, 256, 32)
        sub = block // 32 // bs.k3_chains(block)
        for x in rng.integers(0, 2 ** 32, 4, dtype=np.uint64):
            x = int(x)
            for lane in (0, 7, 30, 31):
                got = int(_apply_cols(fold[lane], np.uint32(x)))
                assert got == tcrc.crc32c_zeros(x, block // 32 * (31 - lane))
            for j in range(1, bs.K3_MAX_CHAINS):
                got = int(_apply_cols(cops[j - 1], np.uint32(x)))
                assert got == tcrc.crc32c_zeros(x, sub * j)
            for i in range(bs.K3_DIGITS):
                for c in (1, 2, 255):
                    got = int(_apply_cols(digits[i, c], np.uint32(x)))
                    assert got == tcrc.crc32c_zeros(x, block * c * 256 ** i)


def test_k3_lane_table_and_nibble_tables():
    """Every lane's copy of the crc table is the byte table; the parity's
    nibble entries hold C[4g+t][j] * (v << 4h) in byte t, and two
    lookups give the product of a byte; an operator's nibble tables
    apply it."""
    ltab = _lane_crc_table().reshape(256, 32)
    want = np.array([tcrc.crc32c(bytes([e]), 0) for e in range(256)],
                    dtype=np.uint32)
    assert (ltab == want[:, None]).all()
    mat = tgf.cauchy_rs_matrix(5, 6)[5:]
    tabs = _tables(mat)
    T = _nibble_packed(tabs)
    assert T.shape == (2, 5, 32)
    x = np.arange(256)
    prod = T[:, :, x & 15] ^ T[:, :, 16 + (x >> 4)]         # [g, j, x]
    byte = (prod[..., None] >> (8 * np.arange(4)).astype(np.uint32)) & 0xFF
    for g in range(2):
        for t in range(4):
            want = tabs[4 * g + t] if 4 * g + t < 6 else 0
            np.testing.assert_array_equal(byte[g, :, :, t], want)
    rng = np.random.default_rng(62)
    cols = rng.integers(0, 2 ** 32, 32, dtype=np.uint64).astype(np.uint32)
    xs = rng.integers(0, 2 ** 32, 50, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(_apply_nibbles(_nibbles(cols), xs),
                                  _apply_cols(cols, xs))


# ----------------------------------------------------------------------------
# the model against Pallas kernel #4 and against K3's plain version
# ----------------------------------------------------------------------------

def _words(chunks):
    return jnp.asarray(chunks.view("<u4").view(np.int32))


def _pallas_acc(mat, chunks, ntiles_run, tile, wb):
    """(parity, L) of one multi-run launch of Pallas #4 in interpret mode."""
    m = mat.shape[0]
    n = chunks.shape[1]
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    run_map, first_map, adv, comb = jbs._acc_launch_args(ntiles_run, tile, wb)
    par_w, lb = jbs._hier_acc_core(
        bitmat32, jnp.asarray(jcl.crc_tile_matrix_w32(wb)), adv, comb,
        run_map, first_map, _words(chunks), m, tile, wb, len(ntiles_run),
        True, "planar")
    par = np.asarray(par_w).view("<u4").view(np.uint8).reshape(m, n)
    return par, jcl.bits_to_u32(np.asarray(lb)).astype(np.int64)


@pytest.mark.parametrize("k,m,wb,blocks_per_tile,ntiles_run,sms", [
    (6, 2, 64, 1, [3, 0, 1, 5], H100_SMS),   # an empty run, a one-block run
    (3, 5, 128, 1, [2, 1, 4], 1),           # two packed groups; blocks walk
    (4, 2, 64, 4, [3, 1, 2], H100_SMS),     # tests/test_torch_acc.py's launch
    (4, 4, 128, 2, [1, 2, 1], 2)])
def test_k3_model_matches_pallas_acc(k, m, wb, blocks_per_tile, ntiles_run,
                                     sms):
    block = 4 * wb
    tile = block * blocks_per_tile
    mat = jgf.cauchy_rs_matrix(k, m)[k:]
    rng = np.random.default_rng(k * 100 + m + wb)
    n = tile * sum(ntiles_run)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    want_par, want_l = _pallas_acc(mat, chunks, ntiles_run, tile, wb)
    ends = np.cumsum(ntiles_run) * blocks_per_tile
    par, lacc = k3_model(_tables(mat), chunks, ends, block, sms)
    np.testing.assert_array_equal(par, want_par)
    live = [i for i, t in enumerate(ntiles_run) if t]
    np.testing.assert_array_equal(lacc[live], want_l[live])
    assert not lacc[[i for i, t in enumerate(ntiles_run) if not t]].any()


@pytest.mark.parametrize("k,m,block,blocks,sms", [
    (8, 3, 2048, [3, 2], H100_SMS),          # the write path's shape
    (8, 3, 1024, [1, 0, 4], 1),              # one thread block walks all
    (8, 6, 512, [0, 2, 1], H100_SMS),        # m > 4, an empty first run
    (10, 4, 4096, [2], 1),
    (5, 3, 384, [2, 3], 2)])                 # odd pieces: two pad words
def test_k3_model_matches_plain(k, m, block, blocks, sms):
    mat = tgf.cauchy_rs_matrix(k, m)[k:]
    rng = np.random.default_rng(block + k + m)
    n = block * sum(blocks)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    ends = np.cumsum(blocks)
    want_par, want_l = bs.fused_hier_acc_call_plain(
        bs.tables_tensor(_tables(mat), CPU), torch.from_numpy(chunks),
        torch.from_numpy(ends), block // 4)
    par, lacc = k3_model(_tables(mat), chunks, ends, block, sms)
    np.testing.assert_array_equal(par, want_par.numpy())
    np.testing.assert_array_equal(lacc, want_l.numpy())

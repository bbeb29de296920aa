"""K3's layout, launch rule and walk on the CPU.

`k3_walk`, `k3_smem`, `k3_launch`, `k3_ranges`, `k3_pad`, `k3_chains`
and `k3_ops` (ops/bitsliced) are the host's mirrors of
csrc/gf_encode_crc_acc.cu: pure functions of the shapes, checked here
over every accepted shape.  `k3_model` is a numpy model of the kernel's
walk on the same operands the kernel receives — the ranges of
`k3_ranges` over the grid of `k3_launch`, the staged rows with their
pads (the scrub block's layout at 2 KiB, else K2's), the packed
parity's nibble tables, its items' words (`walk_word`) and the 4x4
byte transpose, the lane-copied crc table, the interleaved crc chains
seeded with each row's running L and their chain operators, the
per-lane fold operators, the XOR into a run's slot at its end and the
base-256 advance of `k3_ops` at a range's end — held bit-exact against
Pallas kernel #4 in interpret mode (as tests/test_torch_acc.py reaches
it) and against K3's plain version.  The kernel itself is held against
its plain version on the card in tests/test_torch_cuda.py."""

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


def _walk_layout(block: int, scrub: bool) -> tuple[int, int, int]:
    """(words from one lane's piece to the next, words of a row, chains
    a lane) of a row the walk stages: the scrub block's own layout, or
    K2's (k3_pad)."""
    if scrub:
        return bs.K5_SCRUB_STRIDE, 32 * bs.K5_SCRUB_STRIDE, \
            bs.K5_SCRUB_CHAINS
    stride = block // 128 + bs.k3_pad(block)
    return stride, 32 * stride, bs.k3_chains(block)


def _staged_index(block: int, scrub: bool) -> np.ndarray:
    """Where the copies put each word w of a block in a staged row: the
    scrub block's 16-byte chunk v = w // 4 at word 20 * (v // 4) + 4 *
    (v % 4), else w + (w // wpp) * pad."""
    w = np.arange(block // 4)
    if scrub:
        v = w // 4
        return bs.K5_SCRUB_STRIDE * (v // 4) + 4 * (v % 4) + w % 4
    return w + (w // (block // 128)) * bs.k3_pad(block)


def _walk_word(item: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """walk_word: the tile word and staged index of each parity item of
    the scrub block (warp item i // 32 takes lane pieces a = 8 * (warp %
    4) + lane // 4 and words c = 4 * (warp // 4) + lane % 4)."""
    a = 8 * ((item >> 5) & 3) + ((item & 31) >> 2)
    c = 4 * (item >> 7) + (item & 3)
    return 16 * a + c, bs.K5_SCRUB_STRIDE * a + c


def _tile_l(rows: np.ndarray, seeds: np.ndarray, block: int, scrub: bool,
            tabs) -> np.ndarray:
    """A_B . seed ^ L(tile) of each staged row: lane 0's first chain
    starts from the row's running L, every other chain from 0, each word
    XORed in whole before its four byte steps; then the chain operators
    (chain c of `chains` is followed by (chains-1-c) * wpc words, which
    k3_ops's chain operator j covers in j sub-pieces of wpp /
    k3_chains(block) words) and the lane fold."""
    ltab, fold, cnib = tabs
    wpp = block // 128
    stride, _, chains = _walk_layout(block, scrub)
    wpc = wpp // chains
    lanes = np.arange(32)
    piece_idx = lanes[:, None] * stride + np.arange(wpp)[None, :]
    crc = np.zeros((chains, rows.shape[0], 32), dtype=np.uint32)
    crc[0, :, 0] = seeds
    for t in range(wpc):
        for c in range(chains):
            x = rows[:, piece_idx[:, c * wpc + t]] ^ crc[c]
            for _ in range(4):
                x = ltab[((x & np.uint32(0xFF)) << np.uint32(5)) + lanes] \
                    ^ (x >> np.uint32(8))
            crc[c] = x
    sub = wpp // bs.k3_chains(block)
    lane_l = crc[chains - 1].copy()
    for c in range(chains - 1):
        lane_l ^= _apply_nibbles(cnib[(chains - 1 - c) * wpc // sub - 1],
                                 crc[c])
    return np.bitwise_xor.reduce(_apply_lane_nibbles(fold, lane_l), axis=1)


def walk_schedule(run_ends: np.ndarray, ntiles: int, grid: int):
    """The walk's flushes: for each thread block's range (k3_ranges), the
    (run, tiles of the run after the range) of each XOR into the run's
    slots, in order: 0 at a run end met inside the range, the distance
    the range's end advances by otherwise."""
    out = []
    for t0, t1 in bs.k3_ranges(ntiles, grid):
        run = int(np.searchsorted(run_ends, t0, side="right"))
        flushes = []
        for t in range(t0, t1):
            if t + 1 == run_ends[run]:
                flushes.append((run, 0))
                if t + 1 < t1:
                    run = int(np.searchsorted(run_ends, t + 1, side="right"))
        if t1 < run_ends[run]:
            flushes.append((run, int(run_ends[run]) - t1))
        out.append(((t0, t1), flushes))
    return out


def k3_model(tables: np.ndarray, chunks: np.ndarray, run_ends: np.ndarray,
             block: int, sm_count: int = H100_SMS):
    """K3's walk on the kernel's operands, thread block by thread block,
    tile by tile; returns (parity (m, n) uint8, L (nruns, k+m) int64)."""
    m, k, _ = tables.shape
    n = chunks.shape[1]
    r_tot = k + m
    walk = bs.k3_walk(m, k, block)
    W, wpp, pad = block // 4, block // 128, bs.k3_pad(block)
    _, S, _ = _walk_layout(block, walk.scrub)
    groups = -(-m // 4)
    T = _nibble_packed(tables)
    ops = bs.k3_ops(block)
    tabs = (_lane_crc_table(), _nibbles(ops[:1024].reshape(32, 32).T),
            _nibbles(ops[1024:bs.K3_OP_COLS].reshape(bs.K3_MAX_CHAINS - 1,
                                                     32)))
    digits = ops[bs.K3_OP_COLS:].reshape(bs.K3_DIGITS, 256, 32)
    words = np.ascontiguousarray(chunks).view("<u4")   # (k, n/4)
    staged = _staged_index(block, walk.scrub)
    if walk.scrub:
        w_of, pw_of = _walk_word(np.arange(W))        # the parity's items
    else:
        w_of = np.arange(W)
        pw_of = w_of + (w_of // wpp) * pad
    parity = np.zeros((m, n // 4), dtype=np.uint32)
    lacc = np.zeros((len(run_ends), r_tot), dtype=np.uint64)
    grid = bs.k3_launch(n, block, k, m, sm_count)
    for (t0, t1), flushes in walk_schedule(run_ends, n // block, grid):
        L = np.zeros(r_tot, dtype=np.uint32)          # the running L
        flushes = iter(flushes)
        for t in range(t0, t1):
            rows = np.full((r_tot, S), SENTINEL, dtype=np.uint32)
            rows[:k, staged] = words[:, t * W:(t + 1) * W]
            x = rows[:k, pw_of]                       # (k, W) by item
            for g in range(groups):
                acc = np.zeros((W, 4), dtype=np.uint32)
                for j in range(k):
                    for byte in range(4):
                        lo = _nibble(x[j], 2 * byte)
                        hi = _nibble(x[j], 2 * byte + 1)
                        acc[:, byte] ^= T[g, j, lo] ^ T[g, j, 16 + hi]
                acc = _transpose4(acc)
                for r in range(min(4, m - 4 * g)):
                    rows[k + 4 * g + r, pw_of] = acc[:, r]
                    parity[4 * g + r, t * W + w_of] = acc[:, r]
            L = _tile_l(rows, L, block, walk.scrub, tabs)
            if t + 1 in run_ends:                     # a run ends here
                run, dist = next(flushes)
                assert dist == 0 and run_ends[run] == t + 1
                lacc[run] ^= L.astype(np.uint64)
                L[:] = 0
        for run, dist in flushes:                     # the range's end
            assert dist == int(run_ends[run]) - t1 > 0
            for i in range(bs.K3_DIGITS):
                c = (dist >> (8 * i)) & 255
                if c:
                    L = _apply_cols(digits[i, c], L)
            lacc[run] ^= L.astype(np.uint64)
    return parity.view(np.uint8).reshape(m, n), lacc.astype(np.int64)


def _tables(mat):
    return tgf.product_tables(mat)


# ----------------------------------------------------------------------------
# the pure mirrors
# ----------------------------------------------------------------------------

BLOCKS = (128, 256, 384, 512, 1024, 2048, 4096, 8192)


def _smem_formula(m, k, block):
    """K3's admission: one stage of K2's rows with the lane tables."""
    pad = 2 if (block // 128) % 2 else 1
    return 4 * (-(-m // 4) * k * 32 + 8192 + 4480
                + (k + m) * (block // 4 + 32 * pad)) + 16


def _walk_formula(m, k, block, depth, scrub):
    row = 640 if scrub else block // 4 + 32 * (2 if (block // 128) % 2 else 1)
    return 4 * (-(-m // 4) * k * 32 + 8192 + 4480
                + (depth * k + m) * row) + 16


def _walk_rule(m, k, block):
    """The walk's shape as its rule says: two blocks an SM with two
    stages, else one with three, two or one, each in the scrub block's
    layout first where the block is 2 KiB."""
    for per_sm, depth in ((2, 2), (1, 3), (1, 2), (1, 1)):
        for scrub in (True, False) if block == 2048 else (False,):
            smem = _walk_formula(m, k, block, depth, scrub)
            if smem <= 232448 and per_sm * (smem + 1024) <= 233472:
                return per_sm, depth, scrub, smem
    return None


@pytest.mark.parametrize("block", BLOCKS)
def test_k3_smem_accepts_exactly_the_shapes_within_the_limit(block):
    """Every (k, m) whose one-stage layout fits one block's 227 KB is
    accepted, at the walk shape the rule gives, with that layout's exact
    size; the next k past the limit raises.  Every accepted shape has at
    most 512 rows: one lane of K3's 16 warps for each row's running L."""
    for m in range(1, 33):
        k = 1
        while _smem_formula(m, k, block) <= bs.SMEM_LIMIT:
            walk = bs.k3_walk(m, k, block)
            assert tuple(walk) == _walk_rule(m, k, block)
            assert bs.k3_smem(m, k, block) == walk.smem <= bs.SMEM_LIMIT
            assert k + m <= 32 * (bs.K3_THREADS // 32)
            k += 1
        with pytest.raises(ValueError, match="shared memory"):
            bs.k3_smem(m, k, block)


def test_k3_smem_main_shapes_and_edges():
    """The write path's 8+3 at the autotuner's blocks, the card tests'
    10+4, 8+6 and 4+4, LRC's 4+4 generator, and the CPU tests' 512-byte
    block; blocks that are no multiple of 128 raise."""
    # 50.5 KiB of tables, two stages of 8 scrub rows, 3 parity rows
    assert bs.k3_walk(3, 8, 2048) == (2, 2, True, 100368)
    assert bs.k3_smem(3, 8, 2048) == 4 * (8 * 32 + 12672 + 19 * 640) + 16
    assert bs.k3_walk(3, 8, 1024) == (2, 2, False, 73616)
    assert bs.k3_walk(3, 8, 4096) == (1, 3, False, 165776)
    for wb in (256, 512, 1024):                # autotune.SWEEP_WBS
        for k, m in ((8, 3), (10, 4), (8, 6), (4, 2), (4, 4)):
            assert bs.k3_smem(m, k, 4 * wb) <= bs.SMEM_LIMIT
            assert bs.k3_walk(m, k, 4 * wb).depth >= 2
    assert bs.k3_smem(2, 4, 512) == 4 * (4 * 32 + 8192 + 4480 + 10 * 160) + 16
    # where two scrub stages fit no block, K2's rows take the ring; where
    # neither fits, one stage of scrub rows
    assert bs.k3_walk(1, 36, 2048) == (1, 2, False,
                                       _walk_formula(1, 36, 2048, 2, False))
    assert bs.k3_walk(1, 60, 2048) == (1, 1, True,
                                       _walk_formula(1, 60, 2048, 1, True))
    # at the admission edge one stage of K2's rows is K2's own block
    k = 1
    while _smem_formula(1, k + 1, 2048) <= bs.SMEM_LIMIT:
        k += 1
    assert bs.k3_walk(1, k, 2048) == (1, 1, False, _smem_formula(1, k, 2048))
    assert bs.k3_smem(1, k, 2048) == bs._crc_smem_bytes(1, k, 2048)
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


def test_k3_walk_words_meet_no_bank_twice():
    """In the scrub block's layout the parity's items are a permutation
    of the 512 words, staged where the copies put them, and each warp's
    32 items read and write 32 distinct banks; the crc's quarter-warps
    read their lanes' 16-byte chunks from 8 distinct 16-byte bank
    groups."""
    w, pw = _walk_word(np.arange(512))
    assert sorted(w.tolist()) == list(range(512))
    np.testing.assert_array_equal(pw, _staged_index(2048, True)[w])
    for warp in range(16):
        assert len(set((pw[32 * warp:32 * warp + 32] % 32).tolist())) == 32
    for i in range(4):                         # a lane's i-th 16-byte chunk
        for q in range(4):
            lanes = np.arange(8 * q, 8 * q + 8)
            groups = (lanes * bs.K5_SCRUB_STRIDE + 4 * i) // 4 % 8
            assert len(set(groups.tolist())) == 8


@pytest.mark.parametrize("k,m,block", [(8, 3, 2048), (8, 3, 4096),
                                       (10, 4, 1024), (4, 2, 512),
                                       (8, 6, 2048), (4, 4, 2048)])
def test_k3_launch_covers_every_tile_once_in_one_wave(k, m, block):
    """The grid is min(tiles, one wave of the walk shape's blocks an
    SM); its ranges are contiguous, in order, none empty, balanced to
    within one tile, and take every tile exactly once."""
    per_sm = bs.k3_walk(m, k, block).per_sm
    for sms in (1, 3, H100_SMS):
        for tiles in (1, 2, 5, 255, 256, 407, 2049, 8192):
            grid = bs.k3_launch(tiles * block, block, k, m, sms)
            assert grid == min(tiles, per_sm * sms)
            ranges = bs.k3_ranges(tiles, grid)
            assert len(ranges) == grid and ranges[0][0] == 0
            assert all(a < b for a, b in ranges)
            assert all(ranges[i][1] == ranges[i + 1][0]
                       for i in range(grid - 1))
            assert ranges[-1][1] == tiles
            sizes = {b - a for a, b in ranges}
            assert max(sizes) - min(sizes) <= 1


def test_k3_launch_main_path():
    """The cell's 32 runs of 512 KiB in 2 KiB tiles: 264 thread blocks
    (two an SM), 31 or 32 tiles each; a 512 KiB run alone and a
    one-tile drain get ranges of one tile."""
    assert bs.k3_launch(32 * (512 << 10), 2048, 8, 3, H100_SMS) == 264
    assert {b - a for a, b in bs.k3_ranges(8192, 264)} == {31, 32}
    assert bs.k3_launch(512 << 10, 2048, 8, 3, H100_SMS) == 256
    assert bs.k3_launch(407 * 2048, 2048, 8, 3, H100_SMS) == 264
    assert bs.k3_launch(2048, 2048, 8, 3, H100_SMS) == 1


def test_k3_walk_flushes_at_the_cell():
    """The walk's atomics at the cell's shape: each row gets one XOR a
    run end (32) and one a range that ends inside a run (262 of the 264
    ranges: two end on a run end), 294 a row, 3,234 at 8+3, against one
    a tile a row in a per-tile design (90,112); a range flushes at most
    twice."""
    ends = np.arange(1, 33) * 256
    sched = walk_schedule(ends, 8192, 264)
    flushes = [f for _, fl in sched for f in fl]
    assert len(flushes) == 294 and 11 * len(flushes) == 3234
    assert sum(d == 0 for _, d in flushes) == 32
    assert {r for r, _ in flushes} == set(range(32))
    assert max(len(fl) for _, fl in sched) == 2


@pytest.mark.parametrize("n,walked", [(32 * (512 << 10), (8192, 264)),
                                      (2048, (1, 1))])
def test_k3_walk_counts_at_the_cell_and_a_one_tile_drain(n, walked):
    """k3_walk_counts() adds a launch's tiles and ranges from the shapes
    on the host, stays apart from launch_counts() and is zeroed by the
    same reset."""
    saved = list(bs._walk)
    try:
        bs.reset_launch_counts()
        assert bs.k3_walk_counts() == {"launches": 0, "tiles": 0,
                                       "ranges": 0}
        bs._count_k3_walk(n, 2048, 8, 3, H100_SMS)
        bs._count_k3_walk(n, 2048, 8, 3, H100_SMS)
        assert bs.k3_walk_counts() == {"launches": 2,
                                       "tiles": 2 * walked[0],
                                       "ranges": 2 * walked[1]}
        assert "k3_walk" not in bs.launch_counts()
        bs.reset_launch_counts()
        assert bs.k3_walk_counts()["tiles"] == 0
    finally:
        bs._walk[:] = saved


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
    (4, 4, 128, 2, [1, 2, 1], 2),
    (5, 3, 512, 1, [2, 3, 1], 1)])          # the scrub block: ranges of 3
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
    (8, 3, 1024, [1, 0, 4], 1),              # two thread blocks walk all
    (8, 6, 512, [0, 2, 1], H100_SMS),        # m > 4, an empty first run
    (10, 4, 4096, [2], 1),
    (5, 3, 384, [2, 3], 2),                  # odd pieces: two pad words
    # ranges of 6 and 5 tiles: a range over a run end, ranges ending
    # inside runs, an empty run, one-tile runs, more tiles than the grid
    (8, 3, 2048, [3, 0, 1, 5, 2], 1),
    (4, 4, 2048, [9, 14], 1),                # four parity rows: one group
    (8, 6, 2048, [7, 1], 1),                 # two groups in scrub rows
    (4, 2, 128, [600], 1),                   # an advance of two digits
    (36, 1, 2048, [4], 1),                   # K2's rows at 2 KiB
    (60, 1, 2048, [3], 1),                   # one stage of scrub rows
    (77, 1, 2048, [2], 1)])                  # one of K2's: the edge
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

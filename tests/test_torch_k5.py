"""K5 (ops/bitsliced.crc32c_rows_l, csrc/gf_encode_crc_acc.cu) and the
deep-scrub crc entry ops/crc32c_linear.crc32c_rows_device on the CPU.

`crc32c_rows_device(..., device="cpu")` runs K5's plain version; it is
held exactly against the JAX package's crc32c_rows_device (jnp on CPU
XLA) and against the host crc32c on rows of every length class a scrub
chunk holds: empty, shorter than a block, one block, a block plus a
tail, 1 MiB plus a tail.  `k5_model` is a numpy model of the kernel's
schedule and per-block algorithm on the operands the kernel receives:
the grid of `k5_launch` and the warps of `k5_warps`, each warp's
contiguous range of blocks (`k5_ranges`), the row searched once at the
range's start, the blocks staged into the padded rows (the kernel's
division by multiply-high), the lane crc tables, the chains with lane
0's first chain seeded by the running L, their operators and the lane
fold, the XOR into the slot at each row end met, and the base-256
advance of `k3_ops` at a range's end inside a row.  It is held against
the plain version, and the plain version through crc32c_rows_device
against the JAX package's, on the schedule's edge cases.  The kernel
itself is held against its plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import crc32c_linear as jcl
from ceph_tpu_torch.common import crc32c as tcrc
from ceph_tpu_torch.ops import bitsliced as bs
from ceph_tpu_torch.ops import crc32c_linear as tcl
from test_torch_k3_layout import (H100_SMS, SENTINEL, _apply_cols,
                                  _apply_lane_nibbles, _apply_nibbles,
                                  _lane_crc_table, _nibbles)

LENGTHS = [0, 1, 2047, 2048, 2049, 8 << 10, (300 << 10) + 777,
           (1 << 20) + 5]


def _rows(seed, lengths):
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 256, n, dtype=np.uint8) for n in lengths]
    seeds = [int(x) for x in rng.integers(0, 2 ** 32, len(rows))]
    return rows, seeds


@pytest.mark.parametrize("lengths", [
    LENGTHS,
    LENGTHS[::-1],
    [0, 0, 0],
    [2048] * 5,
    [4096 * 3 + 100, 0, 2049, 6144],
    [(1 << 20) + 5, (1 << 20) + 5],
], ids=["all", "reversed", "empty", "blocks", "mixed", "two_1MiB"])
def test_rows_device_matches_reference(lengths):
    rows, seeds = _rows(len(lengths) * 7 + sum(lengths) % 97, lengths)
    want = jcl.crc32c_rows_device(rows, seeds)
    assert tcl.crc32c_rows_device(rows, seeds, device="cpu") == want
    assert tcl.crc32c_rows_plain(rows, seeds) == want
    assert want == [tcrc.crc32c(r, s) for r, s in zip(rows, seeds)]


def test_rows_device_block_sizes_match_reference():
    rows, seeds = _rows(5, [0, 5000, 128 * 9 + 3, 1 << 14])
    for block in (128, 512, 4096):
        assert tcl.crc32c_rows_device(rows, seeds, block, device="cpu") == \
            jcl.crc32c_rows_device(rows, seeds, block)


def test_rows_device_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.crc32c_rows_device([np.zeros(4096, np.uint8)], [0])


def _k5_layout(block: int) -> tuple[int, int, int]:
    """(words from one lane's piece to the next, words of a row, chains
    a lane) of a K5 warp's staged row: the scrub block's own layout, or
    K3's."""
    wpp = block // 128
    if block == bs.K5_SCRUB_BLOCK:
        return bs.K5_SCRUB_STRIDE, 32 * bs.K5_SCRUB_STRIDE, \
            bs.K5_SCRUB_CHAINS
    stride = wpp + bs.k3_pad(block)
    return stride, 32 * stride, bs.k3_chains(block)


def _k5_staged(data: np.ndarray, block: int) -> np.ndarray:
    """Every block as the kernel's copies leave it in a warp's row; the
    pads hold what was there before.  The scrub block: 16-byte chunk v
    to word 20 * (v // 4) + 4 * (v % 4).  Any other: word w to w + q *
    pad, q = w // wpp by the kernel's multiply-high (or w where wpp ==
    1)."""
    W, wpp, pad = block // 4, block // 128, bs.k3_pad(block)
    w = np.arange(W, dtype=np.uint64)
    if block == bs.K5_SCRUB_BLOCK:
        v = w // np.uint64(4)
        dst = (v // np.uint64(4)) * np.uint64(bs.K5_SCRUB_STRIDE) \
            + np.uint64(4) * (v % np.uint64(4)) + w % np.uint64(4)
    else:
        q = w if wpp == 1 else \
            (w * np.uint64(0xFFFFFFFF // wpp + 1)) >> np.uint64(32)
        dst = w + q * np.uint64(pad)
    rows = np.full((data.size // block, _k5_layout(block)[1]), SENTINEL,
                   dtype=np.uint32)
    rows[:, dst.astype(np.int64)] = data.view("<u4").reshape(-1, W)
    return rows


def _k5_block_l(rows: np.ndarray, seeds: np.ndarray, block: int, ops):
    """A_B . seed ^ L(block) of each staged block: lane 0's first chain
    starts from the seed, every other chain from 0, then the chain
    operators (chain c of `chains` advanced by (chains-1-c) * wpc words
    of k3_ops's 4*wpp/4-byte steps) and the lane fold."""
    ltab, fold, cnib = ops
    wpp = block // 128
    stride, _, chains = _k5_layout(block)
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
    # k3_ops's chain operator j advances by j sub-pieces of
    # wpp / k3_chains(block) words
    sub = wpp // bs.k3_chains(block)
    lane_l = crc[chains - 1].copy()
    for c in range(chains - 1):
        j = (chains - 1 - c) * wpc // sub
        lane_l ^= _apply_nibbles(cnib[j - 1], crc[c])
    return np.bitwise_xor.reduce(_apply_lane_nibbles(fold, lane_l), axis=1)


def _warp_row_search(row_ends: np.ndarray, b: int) -> int:
    """warp_row_search: the first row whose end lies past block b, by
    rounds of 32 probes spread over the interval and the first probe
    past b (the ballot)."""
    lo, n = 0, len(row_ends)
    while True:
        step = -(-n // 32)
        probes = np.minimum((np.arange(32) + 1) * step, n)
        f = int(np.argmax(row_ends[lo + probes - 1] > b))
        if step == 1:
            return lo + f
        lo, n = lo + f * step, min(step, n - f * step)


def k5_model(data: np.ndarray, row_ends: np.ndarray, block: int,
             sm_count: int = H100_SMS, stats: dict | None = None):
    """K5's schedule and per-block algorithm on the kernel's operands,
    the warps in step; returns the (nrows,) int64 L slots.  `stats`, if
    given, receives the XORs into slots and the digit advances."""
    nblocks = data.size // block
    lout = np.zeros(len(row_ends), dtype=np.uint64)
    ops = bs.k3_ops(block)
    tabs = (_lane_crc_table(), _nibbles(ops[:1024].reshape(32, 32).T),
            _nibbles(ops[1024:bs.K3_OP_COLS].reshape(bs.K3_MAX_CHAINS - 1,
                                                     32)))
    digits = ops[bs.K3_OP_COLS:].reshape(bs.K3_DIGITS, 256, 32)
    grid = bs.k5_launch(nblocks, block, sm_count)
    ranges = np.array(bs.k5_ranges(nblocks, grid * bs.k5_warps(block)),
                      dtype=np.int64).reshape(-1, 2)
    ranges = ranges[ranges[:, 0] < ranges[:, 1]]
    b0, b1 = ranges[:, 0], ranges[:, 1]
    rows = _k5_staged(data, block)
    # the row of each range's first block, searched once
    lo = np.array([_warp_row_search(row_ends, b) for b in b0],
                  dtype=np.int64)
    assert (lo == np.searchsorted(row_ends, b0, side="right")).all()
    row_end = row_ends[lo]
    L = np.zeros(b0.size, dtype=np.uint32)
    xors = 0
    for i in range(int((b1 - b0).max(initial=0))):
        blk = b0 + i
        on = blk < b1
        L[on] = _k5_block_l(rows[blk[on]], L[on], block, tabs)
        done = on & (blk + 1 == row_end)          # a row end: no advance
        np.bitwise_xor.at(lout, lo[done], L[done].astype(np.uint64))
        xors += int(done.sum())
        L[done] = 0
        step = done & (blk + 1 < b1)              # on to the next body
        lo[step] = np.searchsorted(row_ends, blk[step] + 1, side="right")
        row_end[step] = row_ends[lo[step]]
    tail = b1 < row_end                           # the range ends in a row
    lval, dist = L[tail], row_end[tail] - b1[tail]
    for i in range(bs.K3_DIGITS):
        c = (dist >> (8 * i)) & 255
        lval = np.where(c != 0, _apply_cols(digits[i, c], lval), lval)
    np.bitwise_xor.at(lout, lo[tail], lval.astype(np.uint64))
    if stats is not None:
        stats.update(warps=int(b0.size), xors=xors + int(tail.sum()),
                     advances=int(tail.sum()))
    return lout.astype(np.int64)


def _schedule_facts(counts, block: int, sm_count: int) -> set[str]:
    """What K5's schedule meets on rows of `counts` blocks."""
    nblocks = sum(counts)
    warps = bs.k5_launch(nblocks, block, sm_count) * bs.k5_warps(block)
    ranges = [r for r in bs.k5_ranges(nblocks, warps) if r[0] < r[1]]
    ends = set(np.cumsum(counts).tolist())
    longest = max(b - a for a, b in ranges)
    facts = {"ends_at_row_end"} if any(b in ends for _, b in ranges[:-1]) \
        else set()
    if any(b not in ends for _, b in ranges):
        facts.add("ends_inside_row")
    if max(counts) > longest:
        facts.add("row_longer_than_range")
    if nblocks < warps:
        facts.add("fewer_blocks_than_warps")
    if 0 in counts and 1 in counts:
        facts.add("rows_of_0_and_1_blocks")
    if longest > 1:
        facts.add("runs_of_blocks")
    return facts


# chip_smoke.py's two K5 shapes and its edge shape are cut to fewer rows
# and, with the SM count, to ranges of several blocks
@pytest.mark.parametrize("block,counts,sm_count,facts", [
    pytest.param(2048, [3, 0, 2, 1], H100_SMS, set(), id="2048-counts0"),
    pytest.param(2048, [300, 2], H100_SMS, set(),        # two-digit distance
                 id="2048-counts1"),
    pytest.param(128, [66000, 1], H100_SMS, set(),       # three digits
                 id="128-counts2"),
    pytest.param(384, [4, 0, 0, 5], H100_SMS, set(),     # two pad words
                 id="384-counts3"),
    pytest.param(256, [0, 1, 0], H100_SMS, set(), id="256-counts4"),
    pytest.param(1024, [17], H100_SMS, set(), id="1024-counts5"),
    pytest.param(2048, [3, 61], 1, {"ends_inside_row", "runs_of_blocks"},
                 id="range_ends_inside_row"),
    pytest.param(2048, [2, 2, 4, 56], 1,
                 {"ends_at_row_end", "runs_of_blocks"},
                 id="range_ends_at_row_end"),
    pytest.param(1024, [0, 1, 0, 0, 1, 1, 0, 3, 1, 0] * 8, 1,
                 {"rows_of_0_and_1_blocks", "ends_inside_row",
                  "runs_of_blocks"}, id="rows_of_0_and_1"),
    pytest.param(128, [1, 700, 2, 9], 2,
                 {"row_longer_than_range", "ends_inside_row",
                  "runs_of_blocks"}, id="row_longer_than_range"),
    pytest.param(2048, [3, 0, 2], H100_SMS, {"fewer_blocks_than_warps"},
                 id="fewer_blocks_than_warps"),
    pytest.param(2048, [256] * 3, 2,
                 {"row_longer_than_range", "ends_inside_row",
                  "runs_of_blocks"}, id="chunk_132x512KiB_reduced"),
    pytest.param(2048, [512] * 2 + [300] * 2 + [0, 0, 0] + [1] * 3, 2,
                 {"row_longer_than_range", "rows_of_0_and_1_blocks",
                  "ends_inside_row", "runs_of_blocks"},
                 id="mixed_chunk_reduced"),
    pytest.param(2048, [1, 0, 7, 1, 0, 0, 13, 1] * 4 + [99], 1,
                 {"rows_of_0_and_1_blocks", "row_longer_than_range",
                  "ends_inside_row", "runs_of_blocks"},
                 id="edge_chunk_reduced"),
])
def test_k5_model_matches_plain(block, counts, sm_count, facts):
    """The model of K5's range schedule equals the plain version, each
    row's L is crc(body, 0), and the plain version through the scrub's
    entry (the same bodies with tails and seeds) equals the JAX
    package's crc32c_rows_device."""
    assert facts <= _schedule_facts(counts, block, sm_count)
    rng = np.random.default_rng(block + sum(counts))
    data = rng.integers(0, 256, sum(counts) * block, dtype=np.uint8)
    ends = np.cumsum(counts).astype(np.int64)
    plain = bs.crc32c_rows_l_plain(torch.from_numpy(data),
                                   torch.from_numpy(ends), block)
    stats = {}
    np.testing.assert_array_equal(
        k5_model(data, ends, block, sm_count, stats), plain.numpy())
    # about one XOR a warp and one a row, at most one advance a warp
    assert stats["xors"] <= stats["warps"] + len(counts)
    assert stats["advances"] <= stats["warps"]
    starts = np.concatenate([[0], ends[:-1]]) * block
    want = [tcrc.crc32c(data[a:b * block], 0) for a, b in zip(starts, ends)]
    assert plain.tolist() == want
    rows = [np.concatenate([data[a:b * block],
                            rng.integers(0, 256, (i * 37) % block,
                                         dtype=np.uint8)])
            for i, (a, b) in enumerate(zip(starts, ends))]
    seeds = [int(x) for x in rng.integers(0, 2 ** 32, len(rows))]
    want = jcl.crc32c_rows_device(rows, seeds, block)
    assert tcl.crc32c_rows_device(rows, seeds, block, device="cpu") == want
    assert want == [tcrc.crc32c(r, sd) for r, sd in zip(rows, seeds)]


def test_k5_warp_row_search():
    rng = np.random.default_rng(12)
    for nrows in (1, 2, 31, 32, 33, 132, 1000, 1025, 40000):
        counts = rng.integers(0, 3, nrows)
        counts[-1] += 1
        ends = np.cumsum(counts).astype(np.int64)
        for b in range(0, int(ends[-1]), max(1, int(ends[-1]) // 300)):
            assert _warp_row_search(ends, b) == \
                np.searchsorted(ends, b, side="right")


def test_k5_smem_and_digits():
    # 32 warps of two staged rows each at the scrub block, its lanes'
    # pieces 20 words apart
    assert bs.k5_warps(2048) == 32
    assert bs.k5_smem(2048) == 4 * (256 * 32 + bs.K3_NIB_WORDS
                                    + 2 * 32 * 32 * 20)
    assert bs.k5_smem(1024) == 4 * (256 * 32 + bs.K3_NIB_WORDS
                                    + 2 * 32 * (256 + 32))
    # one K5 block of the scrub block fits one SM, and so do its threads
    assert bs.k5_smem(2048) + bs.BLOCK_SMEM_RESERVED <= bs.SM_SMEM
    assert bs.k5_smem(2048) <= bs.SMEM_LIMIT
    assert 32 * bs.k5_warps(2048) <= 1024
    # wider blocks keep fewer warps, every layout within one block's
    for block, warps in ((4096, 21), (8192, 10), (1 << 16, 1)):
        assert bs.k5_warps(block) == warps
        assert bs.k5_smem(block) <= bs.SMEM_LIMIT
    with pytest.raises(ValueError, match="exceed"):
        bs.k5_smem(1 << 17)
    # the largest row K3_DIGITS base-256 digits advance over
    assert 256 ** bs.K3_DIGITS > (64 << 30) // 2048


def test_stage_gathers_parts_end_to_end():
    parts = [np.arange(5, dtype=np.uint8), np.zeros(0, np.uint8),
             np.full(3, 9, np.uint8)]
    _, t = bs.stage(parts, torch.device("cpu"))
    assert t.tolist() == [0, 1, 2, 3, 4, 9, 9, 9]

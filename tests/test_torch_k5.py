"""K5 (ops/bitsliced.crc32c_rows_l, csrc/gf_encode_crc_acc.cu) and the
deep-scrub crc entry ops/crc32c_linear.crc32c_rows_device on the CPU.

`crc32c_rows_device(..., device="cpu")` runs K5's plain version; it is
held exactly against the JAX package's crc32c_rows_device (jnp on CPU
XLA) and against the host crc32c on rows of every length class a scrub
chunk holds: empty, shorter than a block, one block, a block plus a
tail, 1 MiB plus a tail.  `k5_model` is a numpy model of the kernel's
per-warp algorithm on the operands the kernel receives (the lane crc
tables, the staged row with its pads, the chains and their operators,
the lane fold, the row search and the base-256 advance of `k3_ops`, the
XOR into the row's slot), held against the plain version.  The kernel
itself is held against its plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import crc32c_linear as jcl
from ceph_tpu_torch.common import crc32c as tcrc
from ceph_tpu_torch.ops import bitsliced as bs
from ceph_tpu_torch.ops import crc32c_linear as tcl
from test_torch_k3_layout import (SENTINEL, _apply_cols, _apply_lane_nibbles,
                                  _apply_nibbles, _lane_crc_table, _nibbles)

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


def k5_model(data: np.ndarray, row_ends: np.ndarray, block: int):
    """K5's per-warp algorithm on the kernel's operands, every block at
    once; returns the (nrows,) int64 L slots."""
    W, wpp, pad = block // 4, block // 128, bs.k3_pad(block)
    S = W + 32 * pad
    ltab = _lane_crc_table()
    ops = bs.k3_ops(block)
    fold = _nibbles(ops[:1024].reshape(32, 32).T)      # [lane, i, v]
    cnib = _nibbles(ops[1024:bs.K3_OP_COLS].reshape(bs.K3_MAX_CHAINS - 1,
                                                    32))
    digits = ops[bs.K3_OP_COLS:].reshape(bs.K3_DIGITS, 256, 32)
    chains = bs.k3_chains(block)
    wpc = wpp // chains
    nblocks = data.size // block
    words = data.view("<u4").reshape(nblocks, W)
    # the staging loop: word w of the block to w + (w / wpp) * pad
    rows = np.full((nblocks, S), SENTINEL, dtype=np.uint32)
    pw = np.arange(W) + (np.arange(W) // wpp) * pad
    rows[:, pw] = words
    lanes = np.arange(32)
    piece_idx = lanes[:, None] * (wpp + pad) + np.arange(wpp)[None, :]
    crc = np.zeros((chains, nblocks, 32), dtype=np.uint32)
    for t in range(wpc):
        for c in range(chains):
            x = rows[:, piece_idx[:, c * wpc + t]] ^ crc[c]
            for _ in range(4):
                x = ltab[((x & np.uint32(0xFF)) << np.uint32(5)) + lanes] \
                    ^ (x >> np.uint32(8))
            crc[c] = x
    lane_l = crc[chains - 1].copy()
    for c in range(chains - 1):
        lane_l ^= _apply_nibbles(cnib[chains - 2 - c], crc[c])
    lval = np.bitwise_xor.reduce(_apply_lane_nibbles(fold, lane_l), axis=1)
    blk = np.arange(nblocks)
    row = np.searchsorted(row_ends, blk, side="right")
    dist = row_ends[row] - 1 - blk
    for i in range(bs.K3_DIGITS):
        c = (dist >> (8 * i)) & 255
        adv = _apply_cols(digits[i, c], lval)
        lval = np.where(c != 0, adv, lval)
    lout = np.zeros(len(row_ends), dtype=np.uint64)
    np.bitwise_xor.at(lout, row, lval.astype(np.uint64))
    return lout.astype(np.int64)


@pytest.mark.parametrize("block,counts", [
    (2048, [3, 0, 2, 1]),
    (2048, [300, 2]),                      # two-digit distance
    (128, [66000, 1]),                     # three-digit distance
    (384, [4, 0, 0, 5]),                   # odd pieces: two pad words
    (256, [0, 1, 0]),
    (1024, [17])])
def test_k5_model_matches_plain(block, counts):
    rng = np.random.default_rng(block + sum(counts))
    data = rng.integers(0, 256, sum(counts) * block, dtype=np.uint8)
    ends = np.cumsum(counts).astype(np.int64)
    plain = bs.crc32c_rows_l_plain(torch.from_numpy(data),
                                   torch.from_numpy(ends), block)
    np.testing.assert_array_equal(k5_model(data, ends, block), plain.numpy())
    # each row's L is crc(body, 0)
    starts = np.concatenate([[0], ends[:-1]]) * block
    want = [tcrc.crc32c(data[a:b * block], 0) for a, b in zip(starts, ends)]
    assert plain.tolist() == want


def test_k5_smem_and_digits():
    assert bs.k5_smem(2048) == 4 * (256 * 32 + bs.K3_NIB_WORDS
                                    + 8 * (512 + 32))
    # three K5 blocks of the scrub block fit one SM
    assert 3 * (bs.k5_smem(2048) + bs.BLOCK_SMEM_RESERVED) <= bs.SM_SMEM
    with pytest.raises(ValueError, match="exceed"):
        bs.k5_smem(1 << 16)
    # the largest row K3_DIGITS base-256 digits advance over
    assert 256 ** bs.K3_DIGITS > (64 << 30) // 2048


def test_stage_gathers_parts_end_to_end():
    parts = [np.arange(5, dtype=np.uint8), np.zeros(0, np.uint8),
             np.full(3, 9, np.uint8)]
    _, t = bs.stage(parts, torch.device("cpu"))
    assert t.tolist() == [0, 1, 2, 3, 4, 9, 9, 9]

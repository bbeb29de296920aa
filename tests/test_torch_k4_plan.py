"""K4's launch (ops/bitsliced.k4_plan): a pure function of the shapes,
checked here on the CPU — the shared-memory budget of every pass, the
columns and groups every launch covers, the one-wave rule, the host
mirror against the C layout constants, and a numpy model of the
kernel's blocks (group blocks, passes of source rows, the output
columns as the accumulator) against the host GF(2^8) apply.  The
kernel itself is held against its plain version in
tests/test_torch_cuda.py."""

import re
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ops import bitsliced as bs

H100_SMS = 132
SRC = Path(bs.__file__).resolve().parent.parent / "csrc" / \
    "gf_bitmatmul_stream.cu"


def _columns_covered(n, thread_bytes, col_blocks, tile):
    """The columns one group block's threads take, by the kernel's walk
    (gf_common.cuh block_span)."""
    units = -(-n // thread_bytes)
    got = np.zeros(units, dtype=bool)
    threads = np.arange(bs.K4_THREADS)
    for b in range(col_blocks):
        if tile:
            tu = tile // thread_bytes
            begin, end, step = b * tu, min(b * tu + tu, units), bs.K4_THREADS
        else:
            begin, end = b * bs.K4_THREADS, units
            step = col_blocks * bs.K4_THREADS
        trips = np.arange(max(0, -(-(end - begin) // step)))
        v = begin + threads[:, None] + step * trips[None, :]
        got[v[v < end]] = True
    return got


SHAPES = [(3, 8), (2, 8), (11, 5), (64, 176), (81, 270), (1, 227),
          (1, 228), (4, 454), (9, 455), (300, 3), (13, 100)]


@pytest.mark.parametrize("r,k", SHAPES)
@pytest.mark.parametrize("passes", [None, 1, 2, 3, 4, 8, 64])
def test_k4_plan_budget_holds_for_every_pass(r, k, passes):
    """Every pass's tables of the block's groups fit one block; the
    passes cover the k source rows in order, contiguous, the last one
    the shortest; the group blocks cover every group of four rows.
    A forced pass count too few to fit raises."""
    rows_needed = -(-k // (passes or bs.stream_groups(k)))
    if rows_needed * bs.K4_TABLE_BYTES_PER_ROW > bs.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared memory"):
            bs.k4_plan(r, k, 4096, H100_SMS, None, passes)
        return
    p = bs.k4_plan(r, k, 4096, H100_SMS, None, passes)
    assert p.smem == p.groups_per_block * p.rows_per_pass * \
        bs.K4_TABLE_BYTES_PER_ROW <= bs.SMEM_LIMIT
    assert p.rows_per_pass * (p.passes - 1) < k <= p.rows_per_pass * p.passes
    assert p.passes <= (passes or bs.stream_groups(k))
    groups = -(-r // 4)
    assert p.groups_per_block * (p.group_blocks - 1) < groups \
        <= p.groups_per_block * p.group_blocks
    if passes is None:
        assert p.passes == bs.stream_groups(k)
        # the fewest passes: one fewer would not fit one group's tables
        if p.passes > 1:
            assert -(-k // (p.passes - 1)) * bs.K4_TABLE_BYTES_PER_ROW \
                > bs.SMEM_LIMIT


@pytest.mark.parametrize("n,tile", [
    (1, None), (15, None), (1001, None), (6473, None), (32 * 6473, None),
    (1 << 18, None), (1 << 19, None), (1 << 22, None),
    (1001, 16), (6473, 4096), (1 << 19, 65536)])
@pytest.mark.parametrize("r,k", [(3, 8), (64, 176), (81, 270)])
def test_k4_plan_blocks_cover_every_column(n, tile, r, k):
    p = bs.k4_plan(r, k, n, H100_SMS, tile)
    assert p.thread_bytes in (4, 16)
    if tile:
        assert p.col_blocks == -(-n // tile)
    assert _columns_covered(n, p.thread_bytes, p.col_blocks, tile).all()


@pytest.mark.parametrize("r,k", [(3, 8), (64, 176), (81, 270), (500, 20)])
def test_k4_plan_one_wave_at_most(r, k):
    """Without a tile the grid is one resident wave at most (unless the
    group blocks alone exceed it: one column block each then), and
    exactly enough column blocks for the width below that."""
    for n in (16, 1 << 14, 1 << 17, 207136, 1 << 19, 1 << 22):
        p = bs.k4_plan(r, k, n, H100_SMS)
        per_sm = min(bs.K1_BLOCKS_PER_SM[p.thread_bytes],
                     bs.SM_SMEM // (p.smem + bs.BLOCK_SMEM_RESERVED))
        wave = per_sm * H100_SMS
        need = -(-n // (p.thread_bytes * bs.K4_THREADS))
        assert p.col_blocks == max(1, min(need, wave // p.group_blocks))
        assert p.col_blocks * p.group_blocks <= max(wave, p.group_blocks)


def test_k4_plan_main_and_clay_shapes():
    """At 8 x 512 KiB -> 3 K4 at one pass is K1's launch; the CLAY repair
    matrices take one group a block, one pass of 176 rows (k=8 m=4
    d=11, 32 objects of 8 KiB sub-chunks) and two of 135 (k=8 m=3
    d=10, 32 objects of 6473 B)."""
    assert bs.k4_plan(3, 8, 1 << 19, H100_SMS) == bs.K4Plan(
        16, 1, 8, 1, 1, 128, 8192)
    assert bs.k1_launch(1 << 19, 8, 3, H100_SMS) == (16, 128)
    assert bs.k4_plan(64, 176, 32 * 8192, H100_SMS) == bs.K4Plan(
        16, 1, 176, 1, 16, 8, 176 * 1024)
    assert bs.k4_plan(81, 270, 32 * 6473, H100_SMS) == bs.K4Plan(
        16, 1, 135, 2, 21, 6, 135 * 1024)
    assert bs.k4_plan(81, 270, 6473, H100_SMS).thread_bytes == 4
    assert [bs.k4_plan(3, 8, 1 << 19, H100_SMS, None, g)[2:4]
            for g in (1, 2, 4, 8)] == [(8, 1), (4, 2), (2, 4), (1, 8)]


def test_k4_plan_mirrors_the_c_layout_constants():
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kThreads") == bs.K4_THREADS
    assert const("kSmemLimit") == bs.SMEM_LIMIT
    assert const("kTableBytesPerRow") == bs.K4_TABLE_BYTES_PER_ROW
    assert const("kMaxGroupBlocks") == bs.K4_MAX_GROUP_BLOCKS
    w1, w4 = map(int, re.search(
        r"kMinBlocks = W == 1 \? (\d+) : (\d+);", src).groups())
    assert {4: w1, 16: w4} == bs.K1_BLOCKS_PER_SM
    assert "__shfl" not in src          # no warp-shuffle reduction left
    with pytest.raises(ValueError, match="group blocks"):
        bs.k4_plan(4 * (bs.K4_MAX_GROUP_BLOCKS * 227 + 1), 1, 16, H100_SMS,
                   None, 1)


def _model_k4(mat, chunks, plan, tile):
    """numpy model of K4's blocks: group block y builds its groups'
    packed tables for one pass of source rows at a time; each of its
    threads looks up its columns' bytes and XORs the four rows' words
    into the output (the first pass stores)."""
    r, k = mat.shape
    n = chunks.shape[1]
    tb = plan.thread_bytes
    mul = gf.mul_table()
    out = np.full((r, n), 0xAB, dtype=np.uint8)   # garbage before pass 0
    groups = -(-r // 4)
    units = -(-n // tb)
    for y in range(plan.group_blocks):
        g0 = y * plan.groups_per_block
        for jb in range(0, k, plan.rows_per_pass):
            kp = min(plan.rows_per_pass, k - jb)
            for gl in range(min(plan.groups_per_block, groups - g0)):
                i0 = 4 * (g0 + gl)
                rows = min(4, r - i0)
                # packed table P[j][x]: byte t = C[i0+t][jb+j] * x
                packed = np.zeros((kp, 256), dtype=np.uint32)
                for t in range(rows):
                    packed |= mul[mat[i0 + t, jb:jb + kp]].astype(
                        np.uint32) << (8 * t)
                for b in range(plan.col_blocks):
                    if tile:
                        tu = tile // tb
                        cols = np.arange(b * tu, min(b * tu + tu, units))
                    else:
                        cols = np.arange(b * bs.K4_THREADS, units,
                                         plan.col_blocks * bs.K4_THREADS)
                        cols = (cols[:, None] + np.arange(bs.K4_THREADS)
                                ).reshape(-1)
                        cols = cols[cols < units]
                    byte_cols = (cols[:, None] * tb + np.arange(tb)
                                 ).reshape(-1)
                    byte_cols = byte_cols[byte_cols < n]
                    acc = np.zeros(byte_cols.size, dtype=np.uint32)
                    for j in range(kp):
                        acc ^= packed[j][chunks[jb + j, byte_cols]]
                    for t in range(rows):
                        part = ((acc >> (8 * t)) & 0xFF).astype(np.uint8)
                        if jb == 0:
                            out[i0 + t, byte_cols] = part
                        else:
                            out[i0 + t, byte_cols] ^= part
    return out


@pytest.mark.parametrize("r,k,n,tile,passes", [
    (3, 8, 1 << 14, None, None), (3, 8, 1 << 14, None, 4),
    (64, 176, 8192, None, None), (64, 176, 2 * 8192, 4096, 3),
    (81, 270, 6473, None, None), (81, 270, 2 * 6473, None, None),
    (9, 455, 333, 64, None), (11, 5, 1001, None, 8)])
def test_k4_block_model_matches_host_apply(r, k, n, tile, passes):
    rng = np.random.default_rng(r * 1000 + k + n)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    plan = bs.k4_plan(r, k, n, H100_SMS, tile, passes)
    np.testing.assert_array_equal(_model_k4(mat, chunks, plan, tile),
                                  gf.gf_matvec(mat, chunks))

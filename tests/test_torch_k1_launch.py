"""K1's launch rule and shared-memory layout (ops/bitsliced.k1_launch and
k1_smem): pure functions of the shapes, so they are checked here on the
CPU for every case the card's kernel can be handed.  The kernel itself is
held against its plain version in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ops import bitsliced as bs

H100_SMS = 132


def _columns_covered(n: int, thread_bytes: int, blocks: int,
                     tile: int | None) -> np.ndarray:
    """The columns the launch's threads take, by the kernel's own walk
    (gf_common.cuh block_span): with a tile, block b owns units
    [b*tile_units, (b+1)*tile_units) stepping by the block's threads;
    without, the grid strides over all units."""
    units = -(-n // thread_bytes)
    got = np.zeros(units, dtype=bool)
    threads = np.arange(bs.K1_THREADS)
    for b in range(blocks):
        if tile:
            tu = tile // thread_bytes
            begin, end, step = b * tu, min(b * tu + tu, units), bs.K1_THREADS
        else:
            begin, end = b * bs.K1_THREADS, units
            step = blocks * bs.K1_THREADS
        trips = np.arange(max(0, -(-(end - begin) // step)))
        v = begin + threads[:, None] + step * trips[None, :]
        got[v[v < end]] = True
    return got


@pytest.mark.parametrize("n,tile", [
    (1, None), (15, None), (16, None), (1001, None), (4096 + 4, None),
    (1 << 16, None), ((1 << 20) + 16, None), (3 << 20, None),
    (1, 16), (1001, 16), (1 << 16, 16), (1001, 4096), ((1 << 20) + 16, 4096),
    (3 << 20, 65536), (1 << 16, 65536)])
@pytest.mark.parametrize("thread_bytes", [None, 4, 16])
def test_k1_launch_blocks_cover_every_column(n, tile, thread_bytes):
    tb, blocks = bs.k1_launch(n, 8, 3, 8, tile, thread_bytes)
    assert tb == (thread_bytes or tb) and tb in (4, 16)
    assert blocks >= 1
    if tile:
        assert blocks == -(-n // tile)          # the tile is honoured
    assert _columns_covered(n, tb, blocks, tile).all()


@pytest.mark.parametrize("k,r", [(8, 3), (8, 2), (4, 2), (5, 11), (100, 9),
                                 (300, 3)])
@pytest.mark.parametrize("thread_bytes", [4, 16])
def test_k1_launch_one_wave_at_most(k, r, thread_bytes):
    """Without a tile the grid is never more than one wave of the blocks
    an SM keeps resident by registers and shared memory, and it is
    exactly enough blocks for the width below that."""
    smem = bs.k1_smem(r, k)[1]
    per_sm = min(bs.K1_BLOCKS_PER_SM[thread_bytes],
                 bs.SM_SMEM // (smem + bs.BLOCK_SMEM_RESERVED))
    assert per_sm >= 1
    wave = per_sm * H100_SMS
    for n in (16, 1 << 14, 1 << 17, 1 << 19, 1 << 22, 1 << 26):
        _, blocks = bs.k1_launch(n, k, r, H100_SMS, None, thread_bytes)
        need = -(-n // (thread_bytes * bs.K1_THREADS))
        assert blocks == min(need, wave)


def test_k1_launch_rule_threshold():
    """16 bytes a thread from K1_WIDE_ROW_BYTES_PER_SM bytes of each row
    an SM on 16-byte aligned rows; 4 below it and on ragged rows."""
    wide = bs.K1_WIDE_ROW_BYTES_PER_SM * H100_SMS
    assert bs.k1_launch(wide - 16, 8, 3, H100_SMS)[0] == 4
    assert bs.k1_launch(wide, 8, 3, H100_SMS)[0] == 16
    assert bs.k1_launch(wide + 4, 8, 3, H100_SMS)[0] == 4
    # the main path's widths on the H100
    picks = {w: bs.k1_launch(w, 8, 3, H100_SMS)[0]
             for w in (16 << 10, 128 << 10, 512 << 10, 4 << 20)}
    assert picks == {16 << 10: 4, 128 << 10: 4, 512 << 10: 16, 4 << 20: 16}
    with pytest.raises(ValueError, match="thread_bytes"):
        bs.k1_launch(4096, 8, 3, H100_SMS, thread_bytes=8)


def test_k1_smem_accepts_every_shape_within_the_limit():
    """Every (r, k) with r*k*256 <= SMEM_LIMIT is accepted and its layout
    fits one block: all groups' packed tables, one group a pass, or
    (k > 227) the byte tables; past the limit (the byte tables alone
    too big) it raises."""
    limit = bs.SMEM_LIMIT
    for r in range(1, limit // 256 + 1):
        for k in range(1, limit // (256 * r) + 1):
            stage_groups, smem = bs.k1_smem(r, k)
            assert 0 < smem <= limit
            groups = -(-r // 4)
            if stage_groups == 0:
                assert k * 1024 > limit and smem == r * k * 256
            elif stage_groups == groups:
                assert smem == groups * k * 1024
            else:
                assert stage_groups == 1 and groups * k * 1024 > limit
                assert smem == k * 1024
        k_over = limit // (256 * r) + 1
        with pytest.raises(ValueError, match="shared memory"):
            bs.k1_smem(r, k_over)


def test_k1_smem_main_path_and_pass_shapes():
    assert bs.k1_smem(3, 8) == (1, 8192)        # encode, 8 KiB of packed tables
    assert bs.k1_smem(2, 8) == (1, 8192)        # decode of two shards
    assert bs.k1_smem(11, 5) == (3, 15360)      # three groups at once
    assert bs.k1_smem(9, 100) == (1, 102400)    # passes of four rows
    assert bs.k1_smem(3, 300) == (0, 230400)    # the byte-table branch


@pytest.mark.parametrize("thread_bytes", [None, 4, 16])
def test_k1_wrapper_on_cpu_takes_thread_bytes(thread_bytes):
    rng = np.random.default_rng(51)
    mat = rng.integers(0, 256, (3, 8), dtype=np.uint8)
    chunks = rng.integers(0, 256, (8, 1001), dtype=np.uint8)
    tab = bs.tables_tensor(gf.product_tables(mat), torch.device("cpu"))
    got = bs.gf_bitmatmul(tab, torch.from_numpy(chunks),
                          thread_bytes=thread_bytes)
    np.testing.assert_array_equal(got.numpy(), gf.gf_matvec(mat, chunks))


def test_k1_wrapper_refuses_bad_thread_bytes():
    tab = torch.zeros((3, 8, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="thread_bytes"):
        bs.gf_bitmatmul(tab, torch.zeros((8, 64), dtype=torch.uint8),
                        thread_bytes=8)

"""K2's host-side layout and grid (ops/bitsliced, pure, no card): the
shapes K2 admits, its branch by shape and its grid rule.

K2 runs K3's per-block body (csrc/gf_encode_crc_acc.cu).  Where K3's
layout does not fit one block, K2 takes its narrow branch: one crc table
the lanes share and no fold tables.  Every (k, m, B) that K2's earlier
layout admitted (its formula below, kept as a literal) must still be
admitted, and every point autotune's sweep took must stay legal.
"""

import pytest

from ceph_tpu_torch.ops import autotune
from ceph_tpu_torch.ops import bitsliced as bs

H100_SMS = 132
LIMIT = 232448
BLOCKS = range(128, 8193, 128)


def _old_k2_smem(m, k, block):
    """K2's shared memory before it took K3's body: byte product tables,
    the crc table, five fold operators, k+m rows of block + 128 bytes."""
    return m * k * 256 + 256 * 4 + 5 * 32 * 4 + (k + m) * (block + 128)


def _pad(block):
    return 2 if (block // 128) % 2 else 1


def _wide_smem(m, k, block):
    """K3's layout: nibble parity tables, 32 lane crc tables, the fold's
    nibble tables, padded rows, run and distance."""
    return 4 * (-(-m // 4) * k * 32 + 256 * 32 + 8 * 16 * 32 + 3 * 8 * 16
                + (k + m) * (block // 4 + 32 * _pad(block))) + 16


def _narrow_smem(m, k, block):
    """The narrow branch: nibble parity tables, one crc table, padded
    rows, run and distance."""
    return 4 * (-(-m // 4) * k * 32 + 256
                + (k + m) * (block // 4 + 32 * _pad(block))) + 16


@pytest.mark.parametrize("block", BLOCKS)
def test_k2_admits_every_shape_it_admitted(block):
    for k in range(1, 33):
        for m in range(1, 17):
            wide = _wide_smem(m, k, block) <= LIMIT
            assert bs.k2_lane_tables(m, k, block) == wide
            want = _wide_smem(m, k, block) if wide else \
                _narrow_smem(m, k, block)
            if want <= LIMIT:
                assert bs._crc_smem_bytes(m, k, block) == want
            else:
                assert _old_k2_smem(m, k, block) > LIMIT
                with pytest.raises(ValueError, match="shared memory"):
                    bs._crc_smem_bytes(m, k, block)


def test_k2_branch_by_shape():
    # the write path's shapes keep K3's layout, bytes for bytes
    for k, m, block in ((8, 3, 2048), (8, 3, 1024), (8, 3, 4096),
                        (4, 2, 512), (10, 9, 128), (12, 4, 2048)):
        assert bs.k2_lane_tables(m, k, block)
        assert bs._crc_smem_bytes(m, k, block) == bs.k3_smem(m, k, block)
    assert bs._crc_smem_bytes(3, 8, 2048) == 75664
    # the old layout's shapes that need the narrow branch: at power-of-two
    # blocks, 45 shapes, all at 8 KiB with k + m >= 22
    narrow = [(k, m, b) for k in range(1, 33) for m in range(1, 17)
              for b in (128, 256, 512, 1024, 2048, 4096, 8192)
              if _old_k2_smem(m, k, b) <= LIMIT
              and not bs.k2_lane_tables(m, k, b)]
    assert len(narrow) == 45
    assert all(b == 8192 and k + m >= 22 for k, m, b in narrow)
    assert bs._crc_smem_bytes(4, 20, 8192) == _narrow_smem(4, 20, 8192)
    # the tightest: odd pieces (two pad words) near the limit
    assert not bs.k2_lane_tables(1, 28, 7552)
    assert bs._crc_smem_bytes(1, 28, 7552) <= LIMIT
    # no branch fits, or no block
    for m, k, block in ((16, 32, 8192), (3, 30, 8192)):
        with pytest.raises(ValueError, match="shared memory"):
            bs._crc_smem_bytes(m, k, block)
    for bad in (0, 64, 2000):
        with pytest.raises(ValueError, match="multiple of 128"):
            bs._crc_smem_bytes(3, 8, bad)


@pytest.mark.parametrize("k,m,block", [(8, 3, 2048), (8, 3, 1024),
                                       (8, 3, 4096), (10, 9, 128),
                                       (20, 4, 8192), (28, 1, 7552)])
def test_k2_grid_is_one_wave_over_its_layout(k, m, block):
    smem = bs._crc_smem_bytes(m, k, block) + bs.BLOCK_SMEM_RESERVED
    per_sm = max(1, min(bs.K3_BLOCKS_PER_SM, 2048 // bs.K3_THREADS,
                        bs.SM_SMEM // smem))
    for tiles in (1, 4, 256, per_sm * H100_SMS, 5000):
        grid = bs.k3_launch(tiles * block, block, k, m, H100_SMS, acc=False)
        assert grid == min(tiles, per_sm * H100_SMS)
        # every tile is some block's: blocks stride by the grid
        assert sum(len(range(b, tiles, grid)) for b in range(grid)) == tiles


def test_k2_grid_main_shapes():
    # 8+3 x 512 KiB at 2 KiB: 256 blocks, one each; the flat 8 KiB row: 4
    assert bs.k3_launch(512 << 10, 2048, 8, 3, H100_SMS, acc=False) == 256
    assert bs.k3_launch(8 << 10, 2048, 8, 3, H100_SMS, acc=False) == 4
    # K2's layout is K3's there, so is its grid
    for n in (2048 * 407, 2048 * 1000):
        assert bs.k3_launch(n, 2048, 8, 3, H100_SMS, acc=False) == \
            bs.k3_launch(n, 2048, 8, 3, H100_SMS)
    # the narrow branch keeps one block an SM
    assert bs.k3_launch(8192 * 500, 8192, 20, 4, H100_SMS, acc=False) == \
        H100_SMS


@pytest.mark.parametrize("wb", autotune.SWEEP_WBS + (32, 96, 2048))
def test_autotune_legality_keeps_every_point(wb):
    """Every point legal before stays legal, and every point refused
    stays refused but where only K2's earlier layout refused it (30 of
    the sweep's points, all with k+m >= 28 and m >= 8): K3's layout is
    the legal set now."""
    block = 4 * wb
    widened = []
    for k in range(1, 33):
        for m in range(1, 17):
            fits = block % 128 == 0 and _wide_smem(m, k, block) <= LIMIT
            before = fits and _old_k2_smem(m, k, block) <= LIMIT
            assert autotune._legal(k, m, wb) == fits, (k, m, wb)
            if fits and not before:
                widened.append((k, m))
    assert all(k + m >= 28 and m >= 8 for k, m in widened)
    assert len(widened) == {1024: 29, 512: 1}.get(wb, 0)

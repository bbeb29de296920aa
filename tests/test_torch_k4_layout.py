"""K4's support layout (ops/bitsliced.k4_layout, K4Layout): the groups of
four output rows it forms and the source rows it lists for each, its
packed form, the listed launch of k4_plan, the layout kept for a tables
tensor (k4_layout_of) and k4_support_counts(), checked on the CPU; and a
numpy model of the listed kernel's blocks against the host GF(2^8)
apply.  The kernel itself is held against its plain version in
tests/test_torch_cuda.py.  This file imports nothing of JAX or ceph_tpu.
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import ErasureCodePluginRegistry, gf
from ceph_tpu_torch.ops import bitsliced as bs
from ceph_tpu_torch.parallel import ClayRepairPlan

H100_SMS = 132
CELL_WIDTH = 64 * 8192          # a 64-object call of 4 MiB CLAY objects


def _clay(k, m, d):
    return ErasureCodePluginRegistry.instance().factory(
        "clay", {"k": str(k), "m": str(m), "d": str(d)})


def _matrices(k, m, d):
    codec = _clay(k, m, d)
    return [ClayRepairPlan.build(codec, lost, device="cpu").matrix
            for lost in range(k + m)]


K8M4D11 = _matrices(8, 4, 11)
K8M3D10 = _matrices(8, 3, 10)


def _check_layout(mat, lay):
    """Every output row in exactly one group of at most four; each list
    the ascending union of its rows' nonzero columns."""
    r, k = mat.shape
    assert lay.k == k
    assert sorted(i for g in lay.rows for i in g) == list(range(r))
    assert all(1 <= len(g) <= 4 for g in lay.rows)
    assert len(lay.rows) == len(lay.lists) == -(-r // 4)
    for g, lst in zip(lay.rows, lay.lists):
        want = np.flatnonzero((mat[list(g)] != 0).any(axis=0))
        assert list(lst) == want.tolist()
    assert lay.listed == sum(map(len, lay.lists))
    assert lay.longest == max(map(len, lay.lists))


@pytest.mark.parametrize("lost", range(12))
def test_clay_k8m4d11_groups_list_17_of_176_rows(lost):
    """Every lost chunk of the cell's geometry: 16 groups of four rows,
    each listing exactly 17 of the 176 source rows; every source row is
    still read by some group; the listed launch takes one group a block
    at 17 KiB of tables."""
    mat = K8M4D11[lost]
    assert mat.shape == (64, 176)
    lay = bs.k4_layout(mat)
    _check_layout(mat, lay)
    assert [len(x) for x in lay.lists] == [17] * 16
    assert lay.skips and lay.listed == 272
    assert set().union(*map(set, lay.lists)) == set(range(176))
    plan = bs.k4_plan(64, 176, CELL_WIDTH, H100_SMS, None, None,
                      lay.longest)
    assert plan == bs.K4Plan(16, 1, 17, 1, 16, 16, 17 * 1024)


@pytest.mark.parametrize("lost", range(11))
def test_clay_k8m3d10_layout_is_a_permutation(lost):
    """81 x 270: 21 groups, the last of one row; the regrouping never
    lists more rows in all than the row order's groups."""
    mat = K8M3D10[lost]
    assert mat.shape == (81, 270)
    lay = bs.k4_layout(mat)
    _check_layout(mat, lay)
    ident = sum(int((mat[i:i + 4] != 0).any(axis=0).sum())
                for i in range(0, 81, 4))
    assert lay.listed <= ident < 21 * 270
    assert lay.skips and lay.longest < 270
    plan = bs.k4_plan(81, 270, 32 * 6473, H100_SMS, None, None,
                      lay.longest)
    assert (plan.groups_per_block, plan.group_blocks, plan.passes) == \
        (1, 21, 1)
    assert plan.smem == lay.longest * bs.K4_TABLE_BYTES_PER_ROW


@pytest.mark.parametrize("k,m", [(8, 3), (4, 2), (10, 4), (6, 3)])
def test_dense_cauchy_keeps_the_identity_and_full_lists(k, m):
    """A dense matrix: the row order's groups, every source row listed,
    no skip, and k4_plan at its longest list is the dense plan."""
    mat = gf.cauchy_rs_matrix(k, m)[k:]
    lay = bs.k4_layout(mat)
    assert lay.rows == tuple(tuple(range(i, min(i + 4, m)))
                             for i in range(0, m, 4))
    assert lay.lists == (tuple(range(k)),) * len(lay.rows)
    assert not lay.skips and lay.longest == k
    # no layout to pass: the launch is the dense plan, the parent's
    assert bs.k4_plan(3, 8, 1 << 19, H100_SMS) == \
        bs.K4Plan(16, 1, 8, 1, 1, 128, 8192)


def _one_full_group(rng, r=12, k=100):
    """Rows 0-3 nonzero at every source row, the rest half zeros: a
    layout that skips rows while one group lists all k."""
    mat = rng.integers(1, 256, (r, k), dtype=np.uint8)
    mat[4:][rng.random((r - 4, k)) < 0.5] = 0
    return mat


def test_a_full_group_beside_skipping_ones_takes_the_listed_launch():
    """A group that lists every source row does not make the launch
    dense: the layout still skips rows elsewhere, is kept for the tables
    K4 takes, and its plan has one group a block, which the kernel's
    listed launch requires, where the dense plan would give two."""
    mat = _one_full_group(np.random.default_rng(7))
    lay = bs.k4_layout(mat)
    _check_layout(mat, lay)
    assert lay.longest == 100 and lay.skips
    assert not bs.k1_tables_fit(12, 100)
    tab = bs.tables_tensor(gf.product_tables(mat), torch.device("cpu"))
    assert bs.k4_layout_of(tab)[0] == lay
    for n in (1001, 1 << 19):
        plan = bs.k4_plan(12, 100, n, H100_SMS, None, None, lay.longest)
        assert (plan.groups_per_block, plan.group_blocks, plan.passes,
                plan.smem) == (1, 3, 1, 100 * bs.K4_TABLE_BYTES_PER_ROW)
        assert bs.k4_plan(12, 100, n, H100_SMS).groups_per_block == 2
    with pytest.raises(ValueError, match="support layout"):
        bs.k4_plan(12, 100, 1001, H100_SMS, None, None, 101)


def test_zero_rows_ragged_rows_and_the_packed_form():
    """r = 7: two groups, the second of three rows.  An all-zero row
    lists nothing; a group of only zero rows lists nothing and still
    stores its rows.  packed(): rows (-1 past a group's last), offsets,
    lists."""
    mat = np.zeros((7, 9), dtype=np.uint8)
    mat[0, [1, 2]] = 5
    mat[2, 2] = 7
    mat[4, 8] = 1
    mat[6, [0, 8]] = 3
    lay = bs.k4_layout(mat)
    _check_layout(mat, lay)
    assert [len(g) for g in lay.rows] == [4, 3]
    assert lay.listed < 2 * 9 and lay.skips
    packed = lay.packed()
    assert packed.dtype == np.int32
    rows = packed[:8].reshape(2, 4)
    offsets = packed[8:11]
    lists = packed[11:]
    assert [tuple(x for x in row if x >= 0) for row in rows] == \
        list(lay.rows)
    assert rows[1, 3] == -1
    assert offsets.tolist() == [0, len(lay.lists[0]), lay.listed]
    assert [tuple(lists[offsets[g]:offsets[g + 1]]) for g in range(2)] == \
        list(lay.lists)

    zero = bs.k4_layout(np.zeros((5, 6), dtype=np.uint8))
    assert zero.lists == ((), ()) and zero.longest == 0 and zero.skips
    plan = bs.k4_plan(5, 6, 4096, H100_SMS, None, None, 0)
    assert (plan.rows_per_pass, plan.passes, plan.groups_per_block,
            plan.group_blocks, plan.smem) == (1, 1, 1, 2, 1024)
    with pytest.raises(ValueError, match="coefficients"):
        bs.k4_layout(np.zeros((0, 4), dtype=np.uint8))


@pytest.mark.parametrize("support,passes", [(17, None), (17, 2), (44, 3),
                                            (1, None), (200, 64)])
def test_listed_plan_splits_the_lists_into_passes(support, passes):
    p = bs.k4_plan(81, 270, 6473, H100_SMS, None, passes, support)
    assert p.groups_per_block == 1 and p.group_blocks == 21
    assert p.rows_per_pass * (p.passes - 1) < support <= \
        p.rows_per_pass * p.passes
    assert p.smem == p.rows_per_pass * bs.K4_TABLE_BYTES_PER_ROW
    per_sm = min(bs.K1_BLOCKS_PER_SM[p.thread_bytes],
                 bs.SM_SMEM // (p.smem + bs.BLOCK_SMEM_RESERVED))
    need = -(-6473 // (p.thread_bytes * bs.K4_THREADS))
    assert p.col_blocks == max(1, min(need, per_sm * H100_SMS // 21))


def test_tables_tensor_keeps_the_layout_of_that_tensor_only():
    mat = K8M4D11[3]
    tab = bs.tables_tensor(gf.product_tables(mat), torch.device("cpu"))
    lay, packed = bs.k4_layout_of(tab)
    assert lay == bs.k4_layout(mat)
    np.testing.assert_array_equal(packed.numpy(), lay.packed())
    # another tensor with the same bytes is not known: the dense launch
    assert bs.k4_layout_of(tab.clone()) is None
    assert bs.k4_layout_of(torch.from_numpy(gf.product_tables(mat))) is None
    # a write to the tensor drops its layout
    tab[0, 0, 0] ^= 0
    assert bs.k4_layout_of(tab) is None
    # nothing is kept for a dense matrix, nor for tables K1 takes
    dense = gf.cauchy_rs_matrix(8, 3)[8:]
    assert bs.k4_layout_of(bs.tables_tensor(gf.product_tables(dense),
                                            torch.device("cpu"))) is None
    small = K8M4D11[3][:4, :40]
    assert bs.k4_layout(small).skips and bs.k1_tables_fit(4, 40)
    assert bs.k4_layout_of(bs.tables_tensor(gf.product_tables(small),
                                            torch.device("cpu"))) is None


def test_support_counts_reset_and_stay_apart_from_launch_counts():
    saved = list(bs._support)
    try:
        assert set(bs.k4_support_counts()) == {"launches", "rows_looked_up",
                                               "rows_dense"}
        assert "k4_support" not in bs.launch_counts()
        bs._support[:] = [3, 816, 8448]
        assert bs.k4_support_counts() == {"launches": 3,
                                          "rows_looked_up": 816,
                                          "rows_dense": 8448}
        bs.reset_launch_counts()
        assert bs.k4_support_counts() == {"launches": 0,
                                          "rows_looked_up": 0,
                                          "rows_dense": 0}
        # the plain version on the CPU launches nothing and counts nothing
        tab = bs.tables_tensor(gf.product_tables(K8M4D11[0]),
                               torch.device("cpu"))
        x = torch.zeros((176, 64), dtype=torch.uint8)
        bs.gf_bitmatmul_stream(tab, x)
        assert bs.k4_support_counts()["rows_dense"] == 0
    finally:
        bs._support[:] = saved


def _model_listed(mat, chunks, lay, plan, tile):
    """numpy model of the listed launch: block (x, y) applies group y,
    its listed source rows a pass at a time, to its columns, and writes
    its rows where the group maps them (the first pass stores)."""
    r, k = mat.shape
    n = chunks.shape[1]
    tb = plan.thread_bytes
    mul = gf.mul_table()
    out = np.full((r, n), 0xAB, dtype=np.uint8)   # garbage before pass 0
    units = -(-n // tb)
    for y, (grp, lst) in enumerate(zip(lay.rows, lay.lists)):
        for jb in range(0, max(len(lst), 1), plan.rows_per_pass):
            src = list(lst[jb:jb + plan.rows_per_pass])
            packed = np.zeros((len(src), 256), dtype=np.uint32)
            for t, i in enumerate(grp):
                packed |= mul[mat[i, src]].astype(np.uint32) << (8 * t)
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
                byte_cols = (cols[:, None] * tb + np.arange(tb)).reshape(-1)
                byte_cols = byte_cols[byte_cols < n]
                acc = np.zeros(byte_cols.size, dtype=np.uint32)
                for jj, j in enumerate(src):
                    acc ^= packed[jj][chunks[j, byte_cols]]
                for t, i in enumerate(grp):
                    part = ((acc >> (8 * t)) & 0xFF).astype(np.uint8)
                    if jb == 0:
                        out[i, byte_cols] = part
                    else:
                        out[i, byte_cols] ^= part
    return out


def _sparse(rng, r, k, zeros):
    mat = rng.integers(1, 256, (r, k), dtype=np.uint8)
    mat[rng.random((r, k)) < zeros] = 0
    return mat


@pytest.mark.parametrize("case,n,tile,passes", [
    ("clay11", 8192, None, None), ("clay11", 2 * 8192 + 5, None, 3),
    ("clay10", 6473, None, None), ("clay10", 2 * 6473, 4096, 2),
    ("zeros0", 1001, None, None), ("zeros50", 333, 64, None),
    ("zeros92", 4096 + 16, None, 4), ("zero_rows", 100, None, None),
    ("full_group", 1001, None, None), ("full_group", 2 * 4096, None, 3)])
def test_listed_block_model_matches_host_apply(case, n, tile, passes):
    rng = np.random.default_rng(len(case) * 1000 + n)
    mat = {"clay11": K8M4D11[1], "clay10": K8M3D10[8],
           "zeros0": _sparse(rng, 13, 40, 0.0),
           "zeros50": _sparse(rng, 22, 300, 0.5),
           "zeros92": _sparse(rng, 9, 250, 0.92),
           "zero_rows": np.pad(_sparse(rng, 5, 30, 0.8), ((0, 6), (0, 0))),
           "full_group": _one_full_group(rng)}[case]
    r, k = mat.shape
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    lay = bs.k4_layout(mat)
    plan = bs.k4_plan(r, k, n, H100_SMS, tile, passes,
                      lay.longest if lay.skips else None)
    np.testing.assert_array_equal(_model_listed(mat, chunks, lay, plan, tile),
                                  gf.gf_matvec(mat, chunks))

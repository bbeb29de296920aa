"""The port's host-side GF(2^8) and crc32c code against ceph_tpu's.

Same inputs (numpy, seeded) through both packages; every output is a
byte matrix or a crc, so equality is exact.
"""

import numpy as np
import pytest

from ceph_tpu.common import crc32c as jcrc
from ceph_tpu.ec import gf as jgf
from ceph_tpu.ops import crc32c_linear as jcl
from ceph_tpu_torch.common import crc32c as tcrc
from ceph_tpu_torch.ec import gf as tgf
from ceph_tpu_torch.ops import crc32c_linear as tcl

GEOMETRIES = [(k, m) for k in (2, 4, 8) for m in (1, 2, 3)]


@pytest.mark.parametrize("k,m", GEOMETRIES)
@pytest.mark.parametrize("construction", ["cauchy_rs_matrix",
                                          "vandermonde_rs_matrix"])
def test_generator_matrices_match(construction, k, m):
    got = getattr(tgf, construction)(k, m)
    want = getattr(jgf, construction)(k, m)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgf.expand_to_bitmatrix(got),
                                  jgf.expand_to_bitmatrix(want))


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_recovery_matrix_and_inverse_match(k, m):
    mat = tgf.cauchy_rs_matrix(k, m)
    rng = np.random.default_rng(k * 10 + m)
    for _ in range(6):
        lost = sorted(rng.choice(k + m, size=m, replace=False).tolist())
        survivors = tuple(s for s in range(k + m) if s not in lost)[:k]
        targets = tuple(lost)
        np.testing.assert_array_equal(
            tgf.recovery_matrix(mat, k, survivors, targets),
            jgf.recovery_matrix(mat, k, survivors, targets))
        sub = mat[list(survivors)]
        np.testing.assert_array_equal(tgf.gf_invert_matrix(sub),
                                      jgf.gf_invert_matrix(sub))


def test_gf_matvec_and_product_tables():
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    chunks = rng.integers(0, 256, (5, 777), dtype=np.uint8)
    np.testing.assert_array_equal(tgf.gf_matvec(mat, chunks),
                                  jgf.gf_matvec(mat, chunks))
    tab = tgf.product_tables(mat)
    assert tab.shape == (3, 5, 256)
    for i in range(3):
        for j in range(5):
            for x in (0, 1, 2, 77, 255):
                assert tab[i, j, x] == jgf.gf_mul(int(mat[i, j]), x)


@pytest.mark.parametrize("seed", range(4))
def test_crc32c_random_lengths_and_seeds(seed):
    rng = np.random.default_rng(100 + seed)
    for n in [0, 1, 3, 15, 16, 17, 255, 1024, 2047,
              int(rng.integers(1, 70000))]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        s = int(rng.integers(0, 2 ** 32))
        assert tcrc.crc32c(data, s) == jcrc.crc32c(data, s), n
        assert tcrc.crc32c(data) == jcrc.crc32c(data), n
        assert tcrc.crc32c_zeros(s, n) == jcrc.crc32c_zeros(s, n), n


def test_crc32c_rows_matches():
    rng = np.random.default_rng(7)
    for r, n in [(1, 5), (6, 4096), (11, 9001)]:
        rows = rng.integers(0, 256, (r, n), dtype=np.uint8)
        seeds = [int(x) for x in rng.integers(0, 2 ** 32, r)]
        assert tcrc.crc32c_rows(rows, seeds) == jcrc.crc32c_rows(rows, seeds)


@pytest.mark.parametrize("tile", [4, 64, 512])
def test_crc_matrix_constructions_match(tile):
    np.testing.assert_array_equal(tcl.crc_tile_matrix(tile),
                                  jcl.crc_tile_matrix(tile))
    np.testing.assert_array_equal(tcl.crc_tile_matrix_w32(tile // 4),
                                  jcl.crc_tile_matrix_w32(tile // 4))
    np.testing.assert_array_equal(tcl.crc_advance_matrix(tile),
                                  jcl.crc_advance_matrix(tile))
    np.testing.assert_array_equal(tcl.crc_combine_matrix(4, tile),
                                  jcl.crc_combine_matrix(4, tile))


def test_fold_run_crc_matches():
    rng = np.random.default_rng(11)
    for _ in range(5):
        l = int(rng.integers(0, 2 ** 32))
        seed = int(rng.integers(0, 2 ** 32))
        tail = rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
        body = int(rng.integers(0, 10)) * 2048
        assert tcl.fold_run_crc(l, body, seed, tail) == \
            jcl.fold_run_crc(l, body, seed, tail)

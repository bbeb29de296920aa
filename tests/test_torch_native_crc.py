"""The port's host crc32c (ceph_tpu_torch/common/crc32c.py) on the native
library (common/native.py over native/crc32c.c) and on its numpy
tables: `crc32c`, `crc32c_rows`, `crc32c_zeros` and `crc32c_combine`
must give the JAX package's values (ceph_tpu/common/crc32c.py) on both
paths, and the native path must be the one that runs when the library
builds."""

import numpy as np
import pytest

from ceph_tpu.common import crc32c as jcrc
from ceph_tpu_torch.common import crc32c as tcrc
from ceph_tpu_torch.common import native

LENGTHS = [0, 1, 3, 8, 63, 2048, 2049, 100_003]


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "native":
        if not native.available():
            pytest.skip("no C compiler for the native library")
    else:
        monkeypatch.setattr(native, "load", lambda: None)
    return request.param


@pytest.mark.parametrize("n", LENGTHS)
def test_crc32c_matches_reference(path, n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    for seed in (0, 0xFFFFFFFF, int(rng.integers(0, 2 ** 32))):
        want = jcrc.crc32c(data.tobytes(), seed)
        assert tcrc.crc32c(data, seed) == want
        assert tcrc.crc32c(data.tobytes(), seed) == want
        assert tcrc.crc32c(bytearray(data.tobytes()), seed) == want


def test_crc32c_rows_matches_reference(path):
    rng = np.random.default_rng(2)
    for shape in ((11, 4096), (3, 777), (1, 0), (4, 1)):
        rows = rng.integers(0, 256, shape, dtype=np.uint8)
        seeds = [int(x) for x in rng.integers(0, 2 ** 32, shape[0])]
        assert tcrc.crc32c_rows(rows, seeds) == \
            jcrc.crc32c_rows(rows, seeds)
    # a non-contiguous view is read as its values
    rows = rng.integers(0, 256, (6, 300), dtype=np.uint8)[::2, 5:]
    assert tcrc.crc32c_rows(rows, [1, 2, 3]) == \
        jcrc.crc32c_rows(np.ascontiguousarray(rows), [1, 2, 3])


@pytest.mark.parametrize("length", [0, 1, 7, 4096, 1 << 20, (1 << 33) + 5])
def test_zeros_and_combine_match_reference(path, length):
    rng = np.random.default_rng(length % 1000)
    a, b = (int(x) for x in rng.integers(0, 2 ** 32, 2))
    assert tcrc.crc32c_zeros(a, length) == jcrc.crc32c_zeros(a, length)
    assert tcrc.crc32c_combine(a, b, length) == \
        jcrc.crc32c_combine(a, b, length)


def test_combine_joins_two_pieces(path):
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, 5000, dtype=np.uint8)
    a, b = x[:1234], x[1234:]
    assert tcrc.crc32c_combine(tcrc.crc32c(a, 77), tcrc.crc32c(b, 0),
                               b.size) == tcrc.crc32c(x, 77)


def test_native_path_runs_when_the_library_builds(monkeypatch):
    if not native.available():
        pytest.skip("no C compiler for the native library")
    lib = native.load()
    for name in ("ceph_tpu_crc32c", "ceph_tpu_crc32c_zeros",
                 "ceph_tpu_crc32c_combine"):
        assert getattr(lib, name).argtypes is not None
    # the numpy row walk must not run on the native path
    monkeypatch.setattr(tcrc, "_linear_rows", None)
    monkeypatch.setattr(tcrc, "_apply_int", None)
    data = np.arange(10_000, dtype=np.uint32).view(np.uint8)
    assert tcrc.crc32c(data, 5) == jcrc.crc32c(data.tobytes(), 5)
    assert tcrc.crc32c_zeros(5, 999) == jcrc.crc32c_zeros(5, 999)

"""K4 `gf_bitmatmul_stream` (the counterpart of Pallas kernel #7,
`_make_gf_kernel_w32_stream`) on the CPU, i.e. its plain version (the
contraction split into passes of contiguous source rows, the partials
XOR-accumulated in pass order), against ceph_tpu's streaming kernel in
interpret mode, and the port's tools/w32_sweep on the CPU.  Bytes must
match exactly."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as jgf
from ceph_tpu.ops import bitsliced as jbs
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ops import bitsliced as bs
from ceph_tpu_torch.tools import w32_sweep

CPU = torch.device("cpu")


def _operands(k, r, n, seed):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    return mat, chunks, bs.tables_tensor(gf.product_tables(mat), CPU)


@pytest.mark.parametrize("k,r", [(8, 3), (8, 2), (4, 3), (4, 2)])
def test_stream_matches_jax_streaming_kernel(k, r):
    """The JAX streaming kernel (bit-plane groups on an inner grid axis,
    XOR-accumulated in scratch), interpret mode, 8 KiB a chunk, against
    K4's plain version (row groups XOR-accumulated in order)."""
    n = 8192
    mat, chunks, tab = _operands(k, r, n, 100 * k + r)
    words = jnp.asarray(chunks.view("<u4").view(np.int32))
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    out = jbs.gf_bitmatmul_pallas_w32(bitmat32, words, r, tile=n,
                                      interpret=True, stream=True)
    want = np.asarray(out).view("<u4").view(np.uint8).reshape(r, n)
    got = bs.gf_bitmatmul_stream(tab, torch.from_numpy(chunks))
    assert got.dtype == torch.uint8 and got.shape == (r, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4096, 1000])
def test_stream_serves_k_the_tpu_kernel_refuses(n):
    """k=6 breaks Mosaic's 128 % (4k) rule, so the JAX streaming kernel
    raises; K4 serves it (ragged widths too), equal to the JAX XLA
    apply."""
    mat, chunks, tab = _operands(6, 3, n, n)
    with pytest.raises(ValueError, match="128"):
        jbs.gf_bitmatmul_pallas_w32(
            jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8),
            jnp.zeros((6, 1024), dtype=jnp.int32), 3, tile=4096,
            interpret=True, stream=True)
    want = np.asarray(jbs.gf_bitmatmul_xla(
        jnp.asarray(jbs.interleave_bitmatrix(mat), dtype=jnp.int8),
        jnp.asarray(chunks), 3))
    got = bs.gf_bitmatmul_stream(tab, torch.from_numpy(chunks))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jgf.gf_matvec(mat, chunks))


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_stream_passes_match_jax_streaming_kernel(groups):
    """K4 forced to 1, 2, 4 and 8 passes at #7's own shape (k=8, the
    JAX kernel's 8 // g plane-group steps) against the JAX streaming
    kernel in interpret mode."""
    n = 4096
    mat, chunks, tab = _operands(8, 3, n, 40 + groups)
    words = jnp.asarray(chunks.view("<u4").view(np.int32))
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    out = jbs.gf_bitmatmul_pallas_w32(bitmat32, words, 3, tile=n,
                                      interpret=True, stream=True)
    want = np.asarray(out).view("<u4").view(np.uint8).reshape(3, n)
    got = bs.gf_bitmatmul_stream(tab, torch.from_numpy(chunks),
                                 groups=groups)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16, 32])
def test_stream_groups_all_agree_with_k1(groups):
    """Every pass count (`groups`), dividing k or not, more passes than
    rows too, gives K1's bytes."""
    mat, chunks, tab = _operands(10, 4, 777, groups)
    data = torch.from_numpy(chunks)
    got = bs.gf_bitmatmul_stream(tab, data, groups=groups)
    assert torch.equal(got, bs.gf_bitmatmul(tab, data))


def test_stream_groups_rule_and_bad_launch_parameters():
    """stream_groups(k) is the fewest passes whose one group's packed
    tables (1 KiB a source row) fit one block: one up to k = 227, two
    at the k=8 m=3 d=10 CLAY repair matrix (k = 270)."""
    assert [bs.stream_groups(k) for k in (1, 2, 3, 4, 6, 8, 10, 16, 32)] == \
        [1, 1, 1, 1, 1, 1, 1, 1, 1]
    assert [bs.stream_groups(k) for k in (176, 227, 228, 270, 454, 455)] \
        == [1, 1, 2, 2, 2, 3]
    _, chunks, tab = _operands(8, 3, 256, 1)
    data = torch.from_numpy(chunks)
    for bad in (0, -1, 2.0, True):
        with pytest.raises(ValueError, match="positive integer"):
            bs.gf_bitmatmul_stream(tab, data, groups=bad)
    _, wide, wide_tab = _operands(300, 1, 16, 2)
    with pytest.raises(ValueError, match="shared memory"):
        bs.gf_bitmatmul_stream(wide_tab, torch.from_numpy(wide), groups=1)
    assert torch.equal(
        bs.gf_bitmatmul_stream(wide_tab, torch.from_numpy(wide)),
        bs.gf_bitmatmul_plain(wide_tab, torch.from_numpy(wide)))
    for entry in (bs.gf_bitmatmul, bs.gf_bitmatmul_stream):
        with pytest.raises(ValueError, match="multiple of 16"):
            entry(tab, data, tile=100)
        with pytest.raises(ValueError, match="multiple of 16"):
            entry(tab, data, tile=0)
        assert torch.equal(entry(tab, data, tile=64),
                           bs.gf_bitmatmul_plain(tab, data))


def _sweep(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = w32_sweep.main(list(argv))
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_w32_sweep_on_cpu_checks_both_variants():
    rc, rows = _sweep("--device", "cpu", "--tiles", "65536")
    assert rc == 0
    assert rows == [{"stream": False, "tile": 65536, "exact": True},
                    {"stream": True, "tile": 65536, "exact": True}]


def test_w32_sweep_exits_nonzero_on_a_bad_row(monkeypatch):
    """The port's deviation from the JAX tool: a row that is not exact,
    or raised, makes the exit code 1; tiles wider than a chunk are
    skipped as in the JAX tool."""
    monkeypatch.setattr(bs, "gf_bitmatmul_stream",
                        lambda tab, data, tile=None: bs.gf_bitmatmul(
                            tab, data) ^ 1)
    rc, rows = _sweep("--device", "cpu", "--variants", "1",
                      "--tiles", "65536,8388608")
    assert rc == 1 and rows == [{"stream": True, "tile": 65536,
                                 "exact": False}]
    rc, rows = _sweep("--device", "cpu", "--variants", "0", "--tiles", "24")
    assert rc == 1 and "multiple of 16" in rows[0]["error"]

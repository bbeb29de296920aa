"""`cluster_bench` on the port, on the CPU, against the JAX package's:
the quick matrix with the mesh row on the thread topology gives rows
with the same keys and the same matrix of names in both packages; the
mesh row publishes the mesh that served it; every row carries its
kernel launches; `--device cuda` without a GPU raises.  The process
topology's case is tests/test_torch_cluster_bench_procs.py.

`--scale` is not run here: its smallest run (N=6, short heartbeats)
takes ~80 s on the port alone on this machine's CPU, beyond a tier-1
file's budget."""

import contextlib
import io
import json

import pytest
import torch

from ceph_tpu.tools import cluster_bench as jbench
from ceph_tpu_torch.tools import cluster_bench as tbench
from test_torch_cluster_foundations import port_singletons  # noqa: F401

ARGS = ["--quick", "--seconds", "0.5", "--size", "65536"]
MATRIX = ["replicated", "ec_k8m3", "ec_k8m3_batched", "ec_k8m3_mesh"]


def bench_rows(main, argv) -> list[dict]:
    """The JSON rows one run of `main(argv)` prints, rc 0."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]


def bench_and_counter_rows(rows) -> tuple[list[dict], list[dict]]:
    bench = [r for r in rows if "write_mb_s" in r]
    return bench, [r for r in rows if "write_mb_s" not in r]


@pytest.fixture(scope="module")
def rows():
    """Both packages' quick matrix with the mesh row, the port's on the
    CPU (its CPU mesh repeats the CPU eight times, as the reference's
    tests run on eight virtual CPU devices)."""
    from ceph_tpu.parallel.service import MeshService as JMesh
    from ceph_tpu_torch.parallel.service import MeshService as TMesh
    JMesh.reset()
    TMesh.reset()
    try:
        j = bench_rows(jbench.main, [*ARGS, "--mesh"])
        t = bench_rows(tbench.main, [*ARGS, "--mesh", "--device", "cpu"])
    finally:
        JMesh.reset()
        TMesh.reset()
    return j, t


def test_rows_have_the_reference_keys_and_matrix(rows):
    j, t = rows
    (jb, jc), (tb, tc) = bench_and_counter_rows(j), bench_and_counter_rows(t)
    assert [r["config"] for r in tb] == [r["config"] for r in jb] == MATRIX
    assert [r["config"] for r in tc] == [r["config"] for r in jc] == \
        MATRIX
    for jr, tr in zip(jb, tb):
        assert set(tr) == set(jr), tr["config"]
        assert set(tr["write_lat"]) == set(jr["write_lat"])
        assert tr["errors"] == 0 and tr["ops"] > 0
        assert tr["write_mb_s"] > 0 and tr["read_mb_s"] > 0
    for jr, tr in zip(jc, tc):
        assert set(tr) == set(jr)


def test_mesh_row_names_the_mesh_that_served_it(rows):
    j, t = rows
    jb, tb = bench_and_counter_rows(j)[0], bench_and_counter_rows(t)[0]
    assert [r["mesh"] for r in tb] == [r["mesh"] for r in jb] == \
        [None, None, None, "4x2"]


def test_rows_carry_their_kernel_launches(rows):
    """Each row's `launch_ledger` gains `kernel_launches`, by kernel
    wrapper; on the CPU the wrappers run their plain versions and count
    no launch."""
    from ceph_tpu_torch.ops import bitsliced
    for r in bench_and_counter_rows(rows[1])[0]:
        led = r["launch_ledger"]
        assert set(led["kernel_launches"]) == \
            set(bitsliced.launch_counts())
        assert not any(led["kernel_launches"].values())
        assert led["launches"] >= 0 and led["torch"] == torch.__version__


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks a machine without a GPU")
def test_device_cuda_without_gpu_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(ARGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([*ARGS, "--processes"])

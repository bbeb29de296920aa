"""`cluster_bench --processes` on the port, on the CPU, against the JAX
package's: the quick matrix over process clusters (11 OSD processes, a
cluster a batch window) gives rows with the same keys and names in both
packages, and the port's rows read their kernel launches and mesh plane
through the OSDs' admin sockets."""

from ceph_tpu.tools import cluster_bench as jbench
from ceph_tpu_torch.tools import cluster_bench as tbench
from test_torch_cluster_bench import ARGS, bench_rows

PROCS = [*ARGS, "--processes", "--osds", "11"]


def test_process_rows_have_the_reference_keys_and_matrix():
    j = bench_rows(jbench.main, PROCS)
    t = bench_rows(tbench.main, [*PROCS, "--device", "cpu"])
    assert [r["config"] for r in t] == [r["config"] for r in j] == \
        ["replicated", "ec_k8m3", "ec_k8m3_batched"]
    for jr, tr in zip(j, t):
        assert set(tr) == set(jr) and tr["topology"] == "processes"
        assert tr["errors"] == 0 and tr["write_mb_s"] > 0
        assert tr["read_mb_s"] > 0 and tr["mesh"] is None
        assert "gf_bitmatmul" in tr["launch_ledger"]["kernel_launches"]

"""The port's process cluster on the CPU over BlueStore (the cases of
tests/test_torch_proc_cluster.py on their own module-scoped cluster),
and the daemon entry point's refusals: `--device cuda` without a GPU
and the role whose service is not ported (rgw) exit non-zero, and a
daemon that dies at boot shows its log."""

import subprocess
import sys
import time

import pytest

import test_torch_proc_cluster as base
from ceph_tpu_torch.tools import daemon_main
from ceph_tpu_torch.tools.proc_cluster import ProcCluster


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    yield from base.proc_cluster("bluestore", tmp_path_factory)


@pytest.mark.parametrize("case", base.REPLAYED)
def test_proc_cluster_replay(cluster, case):
    base.run_case(base.PROC, case, cluster=cluster)


def test_cold_restart_keeps_every_acked_write(cluster):
    base.cold_restart_case(cluster)


def _daemon(*argv, timeout=60):
    return subprocess.run([sys.executable, "-m",
                           "ceph_tpu_torch.tools.daemon_main", *argv],
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="checks a machine without a GPU")
def test_daemon_on_cuda_without_gpu_exits_nonzero(tmp_path):
    """No CPU fallback: a mon or an OSD asked for the card where there
    is none exits non-zero at boot, naming the missing device, and
    never prints READY."""
    for argv in (["mon", "--addrs", "127.0.0.1:0"],
                 ["osd", "--id", "0", "--mon", "127.0.0.1:9",
                  "--objectstore", "bluestore", "--data-dir",
                  str(tmp_path / "o0")]):
        proc = _daemon(*argv, "--device", "cuda")
        assert proc.returncode != 0
        assert "READY" not in proc.stdout
        assert "no CUDA device" in proc.stderr


def test_unported_roles_exit_with_their_names():
    """Only `rgw` is left unported: its role exits 2 naming it and
    `spawn_rgw` raises (the `mds` role runs an MDS,
    tests/test_torch_file_service.py)."""
    assert list(daemon_main.NOT_PORTED_ROLES) == ["rgw"]
    assert daemon_main.main(["rgw", "--mon", "127.0.0.1:9"]) == 2
    proc = _daemon("rgw", "--mon", "127.0.0.1:9")
    assert proc.returncode == 2
    assert "rgw (the S3 gateway)" in proc.stderr and "not ported" in \
        proc.stderr
    c = ProcCluster.__new__(ProcCluster)
    with pytest.raises(NotImplementedError, match="not ported"):
        c.spawn_rgw()


def test_boot_failure_shows_the_daemon_log(tmp_path):
    """A daemon that dies at boot raises with the tail of its stderr
    log (here: an unknown object store)."""
    c = ProcCluster(n_osds=1, objectstore="nostore", device="cpu",
                    data_dir=str(tmp_path / "d"), boot_timeout=60)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="osd.0 died at boot") as e:
        c.start()
    assert "unknown objectstore 'nostore'" in str(e.value)
    assert (tmp_path / "d" / "osd.0.log").exists()
    assert all(p.poll() is not None for p in c.mon_procs)   # stopped
    assert time.time() - t0 < 60

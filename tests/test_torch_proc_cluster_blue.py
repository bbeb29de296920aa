"""The port's process cluster on the CPU over BlueStore (the cases of
tests/test_torch_proc_cluster.py on their own module-scoped cluster);
every role of the reference's daemon entry point runs in the port's;
its refusals: `--device cuda` without a GPU exits non-zero, and a
daemon that dies at boot shows its log."""

import argparse
import subprocess
import sys
import time
import urllib.request

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


def _roles(main, monkeypatch) -> set[str]:
    """The roles a daemon_main's parser accepts: the choices of its
    subcommand, read as it parses."""
    seen = {}

    def grab(parser, *_a, **_k):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        seen.update(sub.choices)
        raise SystemExit(0)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main([])
    return set(seen)


def test_every_reference_role_runs_in_the_port(cluster, monkeypatch):
    """The port's daemon_main takes every role the reference's does, each
    dispatched to its own runner (no role exits as not ported), and each
    runs: this module's cluster runs the mons and OSDs, and the `rgw`
    and `mds` roles start through ProcCluster and serve."""
    from ceph_tpu.tools import daemon_main as ref
    roles = _roles(ref.main, monkeypatch)
    assert roles == _roles(daemon_main.main, monkeypatch) == \
        {"mon", "osd", "mds", "rgw"}
    assert not hasattr(daemon_main, "NOT_PORTED_ROLES")
    argv = {"mon": ["--addrs", "127.0.0.1:9"],
            "osd": ["--id", "0", "--mon", "127.0.0.1:9"],
            "mds": ["--mon", "127.0.0.1:9"],
            "rgw": ["--mon", "127.0.0.1:9"]}
    for role in roles:
        ran = []
        monkeypatch.setattr(daemon_main, f"run_{role}",
                            lambda args, role=role: ran.append(role) or 0)
        assert daemon_main.main([role, *argv[role]]) == 0
        assert ran == [role]
    monkeypatch.undo()
    assert all(p.poll() is None for p in cluster.mon_procs)
    assert all(p.poll() is None for p in cluster.osd_procs)
    host, port = cluster.spawn_rgw()
    with urllib.request.urlopen(f"http://{host}:{port}/", timeout=60) as r:
        assert r.status == 200 and b"ListAllMyBucketsResult" in r.read()
    host, port = cluster.spawn_mds("a")
    assert port > 0 and cluster.mds_procs["a"].poll() is None


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

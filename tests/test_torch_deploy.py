"""The port's deployer (tools/deploy.py): tests/test_deploy.py replayed on
the port with `apply --device cpu`, and a cluster directory written by
either package's `apply` listed, stopped and removed by the other's
`ls` and `rm-cluster` (the unit files, spec.json and monmap.json keep
one format)."""

import json
import subprocess
import sys
import time

import pytest

from ceph_tpu_torch.tools import deploy
from ceph_tpu_torch.tools.deploy import _alive
from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

DEPLOY = ported("test_deploy", subs=[(
    'run_deploy("apply", str(spec), "--dir", str(d), timeout=300)',
    'run_deploy("apply", str(spec), "--dir", str(d), "--device", "cpu",\n'
    '               timeout=300)')])
# the reference's own fixture, on the port
cluster_dir = DEPLOY.cluster_dir


@pytest.mark.parametrize("case", cases(DEPLOY))
def test_deploy_replay(case, request):
    replay(DEPLOY, case, request)


def _deploy(package: str, *argv, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.tools.deploy", *argv],
        capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("applier,reader", [
    ("ceph_tpu", "ceph_tpu_torch"), ("ceph_tpu_torch", "ceph_tpu")])
def test_units_cross_packages(applier, reader, tmp_path):
    """A directory one package's `apply` wrote: the other's `ls` lists
    the same units running, and its `rm-cluster` stops every pid and
    removes the directory."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"mons": 1, "osds": 1,
                                "objectstore": "memstore"}))
    d = tmp_path / "c"
    extra = ["--device", "cpu"] if applier == "ceph_tpu_torch" else []
    r = _deploy(applier, "apply", str(spec), "--dir", str(d), *extra)
    try:
        assert r.returncode == 0, r.stderr[-2000:]
        units = {p.stem: json.loads(p.read_text())
                 for p in sorted((d / "units").glob("*.json"))}
        assert set(units) == {"mon.0", "osd.0"}
        assert all(set(u) == {"name", "argv", "pid", "addr", "started"}
                   for u in units.values())
        want = {"--device", "cpu"} if extra else set()
        assert all(want <= set(u["argv"]) for u in units.values())
        mine = [json.loads(ln) for ln in
                _deploy(applier, "ls", "--dir", str(d)).stdout.splitlines()]
        got = [json.loads(ln) for ln in
               _deploy(reader, "ls", "--dir", str(d)).stdout.splitlines()]
        assert got == mine
        assert [u["name"] for u in got] == ["mon.0", "osd.0"]
        assert all(u["state"] == "running" for u in got)
        assert {u["pid"] for u in got} == {u["pid"] for u in units.values()}
        r = _deploy(reader, "rm-cluster", "--dir", str(d))
        assert r.returncode == 0, r.stderr[-2000:]
        assert not d.exists()
        time.sleep(0.5)
        survivors = [u["pid"] for u in units.values() if _alive(u["pid"])]
        assert not survivors, f"pids {survivors} survived rm-cluster"
    finally:
        if d.exists():
            _deploy(applier, "rm-cluster", "--dir", str(d))


def test_apply_records_the_device_on_mons_and_osds_only(tmp_path,
                                                       monkeypatch):
    """`--device` reaches the mon and OSD argv (what `start` re-execs)
    and not the mds and rgw roles, which take none; the card is the
    default."""
    spawned = {}
    monkeypatch.setattr(deploy, "_spawn", lambda root, name, argv:
                        spawned.update({name: argv}) or "127.0.0.1:1")
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"mons": 1, "osds": 2, "mds": ["a"],
                                "rgw": 1}))
    for dev, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
        spawned.clear()
        assert deploy.main(["apply", str(spec), "--dir",
                            str(tmp_path / dev), *extra]) == 0
        assert set(spawned) == {"mon.0", "osd.0", "osd.1", "mds.a",
                                "rgw.0"}
        for name, argv in spawned.items():
            if name.split(".")[0] in ("mon", "osd"):
                assert argv[-2:] == ["--device", dev], (name, argv)
            else:
                assert "--device" not in argv, (name, argv)

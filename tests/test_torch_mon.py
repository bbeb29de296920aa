"""The monitor of the port against the JAX package's: a 3-mon port
quorum elects and commits a `torch` EC pool; the mon validates a
`torch` profile by building its codec on the mon's device (the CPU
here; a CUDA request without a GPU is the command's error) and rejects
a bad profile as the reference's mon does; a few cases of
tests/test_mon_paxos.py and tests/test_mon_store.py replay on the port.
The persistent mon store is not ported: a data dir raises."""

import errno

import numpy as np
import pytest
import torch

from ceph_tpu.mon import Monitor as JMonitor
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.mon.store import MonitorStore
from ceph_tpu_torch.store import create_store
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)


def wait_until(pred, timeout=10.0):
    import time
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_quorum_elects_and_commits_torch_ec_pool():
    with Cluster(n_osds=3, n_mons=3, device="cpu") as c:
        leader = c.wait_for_leader()
        assert leader.rank == 0
        assert sorted(m.paxos.role for m in c.mons) == \
            ["leader", "peon", "peon"]
        client = c.client()
        client.set_ec_profile("tq", {"plugin": "torch", "k": "2",
                                     "m": "1", "stripe_unit": "1024"})
        client.create_pool("tqp", "erasure", erasure_code_profile="tq",
                           pg_num=4)
        assert wait_until(lambda: len({m.osdmap.epoch
                                       for m in c.mons}) == 1)
        for m in c.mons:
            assert m.osdmap.lookup_pool("tqp") is not None
            prof = m.osdmap.ec_profiles["tq"]
            # the mon's validation device stays out of the profile
            assert prof["plugin"] == "torch" and "device" not in prof
        io = client.open_ioctx("tqp")
        data = np.random.default_rng(0).integers(
            0, 256, 9000, dtype=np.uint8).tobytes()
        io.write_full("q1", data)
        assert io.read("q1", len(data)) == data


def _profile_set(mon, name, prof):
    return mon.handle_command({"prefix": "osd erasure-code-profile set",
                               "name": name, "profile": prof})


@pytest.fixture()
def mons():
    t, j = Monitor(device="cpu"), JMonitor()
    yield t, j
    t.shutdown()
    j.shutdown()


def test_torch_profile_normalized_like_jax_profile(mons):
    t, j = mons
    rt, out_t = _profile_set(t, "p", {"plugin": "torch", "k": "4",
                                      "m": "2", "stripe_unit": "1024"})
    rj, out_j = _profile_set(j, "p", {"plugin": "jax", "k": "4",
                                      "m": "2", "stripe_unit": "1024"})
    assert rt == rj == 0
    assert out_t["chunk_count"] == out_j["chunk_count"] == 6
    assert {k: v for k, v in out_t["profile"].items() if k != "plugin"} \
        == {k: v for k, v in out_j["profile"].items() if k != "plugin"}
    # the default profile names the card's plugin
    assert t.osdmap.ec_profiles["default"]["plugin"] == "torch"
    # a profile that names its device keeps it
    rt, out_t = _profile_set(t, "pc", {"plugin": "torch", "k": "2",
                                       "m": "1", "device": "cpu"})
    assert rt == 0 and out_t["profile"]["device"] == "cpu"


@pytest.mark.parametrize("prof", [
    {"plugin": "no_such_plugin"},
    {"plugin": "{card}", "k": "0", "m": "1"},
    {"plugin": "jerasure", "k": "2", "m": "1", "technique": "nope"}],
    ids=["bad_plugin", "bad_k", "bad_technique"])
def test_bad_profile_rejected_like_reference(mons, prof):
    t, j = mons
    card = lambda p, name: {k: (name if v == "{card}" else v)
                            for k, v in p.items()}
    rt, out_t = _profile_set(t, "bad", card(prof, "torch"))
    rj, out_j = _profile_set(j, "bad", card(prof, "jax"))
    assert rt < 0 and rj < 0 and rt == rj
    assert "error" in out_t
    assert "bad" not in t.osdmap.ec_profiles


def test_cuda_validation_without_gpu_returns_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mon, prof in ((Monitor(device="cuda"), {}),
                      (Monitor(device="cpu"), {"device": "cuda"})):
        try:
            r, out = _profile_set(mon, "g", {"plugin": "torch", "k": "2",
                                             "m": "1", **prof})
            assert r == -errno.ENODEV
            assert "no CUDA device" in out["error"]
            assert "g" not in mon.osdmap.ec_profiles
        finally:
            mon.shutdown()


def test_persistent_stores_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        MonitorStore(str(tmp_path / "m"))
    with pytest.raises(NotImplementedError, match="not ported"):
        Monitor(data_dir=str(tmp_path / "m"), device="cpu")
    for kind in ("filestore", "bluestore", "bluestore-zlib"):
        with pytest.raises(NotImplementedError, match="not ported"):
            create_store(kind, str(tmp_path / kind))
    assert create_store("memstore") is not None


MON_PAXOS = ported("test_mon_paxos")


@pytest.mark.parametrize("case", [
    "test_three_mons_elect_and_replicate",
    "test_commands_via_peon_are_forwarded",
    "test_mon_stat_reports_quorum", "test_single_mon_is_its_own_quorum",
    "test_partitioned_peon_stops_serving_reads"])
def test_mon_paxos_replay(case):
    run_case(MON_PAXOS, case)


MON_STORE = ported("test_mon_store", subs=[(
    'Monitor(data_dir=str(tmp_path / f"m{i}"))', 'Monitor(device="cpu")')])


def test_mon_services_state_in_memory():
    """Every PaxosService mutated through the command surface of an
    in-memory mon (tests/test_mon_store.py's state, without a restart:
    the persistent store is not ported)."""
    mon = Monitor(device="cpu")
    try:
        MON_STORE._mk_state(mon)
        MON_STORE._assert_state(mon)
    finally:
        mon.shutdown()


@pytest.mark.parametrize("case", [
    "test_auth_surfaces_not_readable_with_readonly_caps",
    "test_auth_entity_replicates_to_peons"])
def test_mon_store_replay(case, tmp_path):
    run_case(MON_STORE, case, tmp_path=tmp_path)

"""The port's clusters on the persistent stores, on the CPU: the monitor
in a data dir (tests/test_mon_store.py replayed with its restarts),
`vstart --objectstore bluestore --data-dir`, an overwrite made while a
shard's OSD is down and read after its revive, and a parity case that writes the same objects into a
reference cluster (`plugin=jax`) and a port cluster (`plugin=torch`)
over BlueStore, whose OSD stores must then hold the same shard bytes
and HashInfos — in the running cluster and after both are stopped and
every store directory is mounted by the other package."""

import numpy as np
import pytest

import ceph_tpu.store as jstore
import ceph_tpu_torch.store as tstore
from ceph_tpu.tools.vstart import Cluster as JCluster
from ceph_tpu_torch.tools import vstart
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster import _drive, check_hinfo_crcs, shard_state
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

MON_STORE = ported("test_mon_store")


@pytest.mark.parametrize("case", [
    "test_standalone_mon_state_survives_restart",
    "test_full_quorum_restart_survives",
    "test_lagging_mon_catches_up_from_quorum",
    "test_cluster_data_survives_mon_quorum_restart",
    "test_quorum_loss_rolls_back_uncommitted_mutation",
    "test_mds_reboot_keeps_active"])
def test_mon_store_restart_replay(case, tmp_path):
    run_case(MON_STORE, case, tmp_path=tmp_path)


def test_mon_data_dir_opens_in_the_other_package(tmp_path):
    """A mon data dir written by the reference's monitor restarts the
    port's with its maps, profiles and pools, and the reverse."""
    from ceph_tpu.mon import Monitor as JMonitor
    from ceph_tpu_torch.mon import Monitor as TMonitor
    for writer, reader in ((JMonitor, TMonitor), (TMonitor, JMonitor)):
        d = str(tmp_path / writer.__module__.split(".")[0])
        mon = writer(data_dir=d)
        MON_STORE._mk_state(mon)
        epoch, version = mon.osdmap.epoch, mon.paxos_version
        mon.shutdown()
        back = reader(data_dir=d)
        try:
            MON_STORE._assert_state(back)
            assert (back.osdmap.epoch, back.paxos_version) == \
                (epoch, version)
        finally:
            back.shutdown()


def test_vstart_cli_on_bluestore(tmp_path, monkeypatch, capsys):
    """`vstart --objectstore bluestore --data-dir D --device cpu` puts
    the mon and every OSD in D and stops at Ctrl-C."""
    def interrupt(_s):
        raise KeyboardInterrupt
    monkeypatch.setattr(vstart.time, "sleep", interrupt)
    d = tmp_path / "vs"
    assert vstart.main(["--osds", "3", "--device", "cpu", "--heartbeat",
                        "0", "--objectstore", "bluestore", "--data-dir",
                        str(d)]) == 0
    assert "3 osds up on cpu" in capsys.readouterr().out
    assert sorted(p.name for p in d.iterdir()) == \
        ["mon.0", "osd.0", "osd.1", "osd.2"]
    assert (d / "osd.1" / "block").exists()


def _stores(root, pkg, n):
    out = []
    for i in range(n):
        s = pkg.create_store("bluestore", f"{root}/osd.{i}")
        s.mount()
        out.append(s)
    return out


def test_bluestore_clusters_store_the_same_shards(tmp_path):
    """The same writes into a reference cluster and a port cluster over
    BlueStore: the same shard bytes and HashInfos OSD by OSD, while
    they run and after, each store directory mounted by the other
    package."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    with JCluster(n_osds=6, objectstore="bluestore", data_dir=jroot) as jc, \
            Cluster(n_osds=6, device="cpu", objectstore="bluestore",
                    data_dir=troot) as tc:
        _drive(jc, "jax")
        _drive(tc, "torch")
        live = [shard_state(o.store) for o in tc.osds]
        for j_osd, t_state in zip(jc.osds, live):
            assert shard_state(j_osd.store) == t_state, j_osd.osd_id
        assert sum(len(s) for s in live) >= 21 * 6
        assert check_hinfo_crcs(tc.osds) >= 20 * 6
    # stopped: each package mounts the other's directories
    for root, pkg in ((jroot, tstore), (troot, jstore)):
        stores = _stores(root, pkg, 6)
        try:
            assert [shard_state(s) for s in stores] == live
        finally:
            for s in stores:
                s.umount()


@pytest.mark.parametrize("slot", [0, 1, 3],
                         ids=["primary", "data", "parity"])
def test_overwrite_while_a_shard_is_down_survives_its_revive(tmp_path,
                                                             slot):
    """An overwrite acked while the OSD of one shard is down leaves that
    OSD's copy stale; when it comes back, peering rebuilds the copy
    from the current shards, so every read after the revive returns
    the overwrite — whichever shard was down (ceph_tpu's peering
    leaves the stale copy in place and serves it)."""
    rng = np.random.default_rng(40 + slot)
    with Cluster(n_osds=5, device="cpu", objectstore="bluestore",
                 data_dir=str(tmp_path / "c")) as c:
        cl = c.client()
        cl.set_ec_profile("ow", {"plugin": "torch", "k": "2", "m": "2",
                                 "technique": "cauchy",
                                 "stripe_unit": "1024"})
        cl.create_pool("owpool", "erasure", erasure_code_profile="ow",
                       pg_num=8)
        io = cl.open_ioctx("owpool")
        data = bytearray(rng.integers(0, 256, 9000, dtype=np.uint8))
        io.write_full("obj", bytes(data))
        pgid = cl.objecter._calc_target(io.pool_id, "obj")[0].pgid
        victim = cl.objecter.osdmap.pg_to_up_acting_osds(pgid)[1][slot]
        c.kill_osd(victim)
        c.mark_osd_down(victim)
        patch = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        io.write("obj", patch, offset=500)      # touches both data shards
        data[500:3500] = patch
        assert io.read("obj", len(data)) == bytes(data)
        c.revive_osd(victim)
        c.wait_active_clean(timeout=60)
        assert io.read("obj", len(data)) == bytes(data)
        # the rebuilt copy is whole: with two other shards' OSDs down the
        # revived shard is one of the k that serve the read
        acting = cl.objecter.osdmap.pg_to_up_acting_osds(pgid)[1]
        for other in [o for o in acting if o != victim][:2]:
            c.kill_osd(other)
            c.mark_osd_down(other)
        assert io.read("obj", len(data)) == bytes(data)

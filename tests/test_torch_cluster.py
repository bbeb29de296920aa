"""The port's cluster as a whole, on the CPU: a mon and OSD daemons over
the loopback messenger, MemStore underneath, the `torch` plugin's
plain versions behind every EC PG (`device="cpu"`).

tests/test_cluster.py replays on a 6-OSD port cluster with a `torch`
pool; tests/test_repair.py's mClock recovery case replays too; the
dispatch-ahead window held open for good (`ec_dispatch_ahead`) writes
and deep-scrubs through the `scrub` asok; and a parity case writes the
same seeded objects into a reference cluster (`plugin=jax`) and a port
cluster, whose OSD stores must then hold the same shard bytes, HashInfo
crcs and sizes, OSD by OSD."""

import numpy as np
import pytest

from ceph_tpu.tools.vstart import Cluster as JCluster
from ceph_tpu_torch.common import crc32c as crc
from ceph_tpu_torch.osd.ec_util import HINFO_KEY, HashInfo
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

PROFILE = {"plugin": "torch", "k": "4", "m": "2", "technique": "cauchy",
           "stripe_unit": "1024"}


def shard_state(store):
    """{(collection, object): (shard bytes, hinfo fields)} of every
    shard that carries a HashInfo (pg logs and metadata left out: they
    carry map epochs)."""
    out = {}
    for cid in store.list_collections():
        for oid in store.list_objects(cid):
            attrs = store.getattrs(cid, oid)
            if HINFO_KEY not in attrs:
                continue
            h = HashInfo.decode(attrs[HINFO_KEY])
            out[(str(cid), str(oid))] = (
                bytes(store.read(cid, oid)),
                (h.total_chunk_size, list(h.cumulative_shard_hashes),
                 h.logical_size, h.invalidated))
    return out


def check_hinfo_crcs(osds) -> int:
    """Every valid HashInfo crc of every shard on every OSD equals the
    host crc32c of the shard's bytes; returns the shards checked."""
    n = 0
    for osd in osds:
        if osd is None:
            continue
        for (cid, oid), (data, (size, hashes, _lsz, inval)) in \
                shard_state(osd.store).items():
            if inval:
                continue
            shard = int(cid.rsplit("s", 1)[1])
            assert len(data) == size, (osd.osd_id, cid, oid)
            assert crc.crc32c(data, 0xFFFFFFFF) == hashes[shard], \
                (osd.osd_id, cid, oid)
            n += 1
    return n


# -- tests/test_cluster.py on the port ---------------------------------------

CLUSTER = ported("test_cluster")


@pytest.fixture(scope="module")
def cluster():
    with Cluster(n_osds=6, device="cpu") as c:
        yield c


@pytest.fixture(scope="module")
def client(cluster):
    return cluster.client()


@pytest.fixture(scope="module")
def ecpool(cluster, client):
    client.set_ec_profile("testprofile", PROFILE)
    client.create_pool("ecpool", "erasure",
                       erasure_code_profile="testprofile", pg_num=8)
    return client.open_ioctx("ecpool")


# in the reference's order: the last three kill OSDs 5 and then 4
@pytest.mark.parametrize("case", [
    "test_status", "test_profile_roundtrip",
    "test_profile_validation_rejects_bad", "test_ec_pool_write_read",
    "test_ec_pool_many_objects", "test_ec_partial_overwrite_rmw",
    "test_replicated_pool", "test_degraded_read_after_osd_down",
    "test_write_while_degraded", "test_write_blocked_below_min_size"])
def test_cluster_replay(cluster, client, ecpool, case):
    run_case(CLUSTER, case, cluster=cluster, client=client, ecpool=ecpool)
    check_hinfo_crcs(cluster.osds)


def test_recovery_rides_mclock_recovery_class():
    run_case(ported("test_repair"),
             "test_recovery_rides_mclock_recovery_class")


# -- an overwrite whose head and tail stripes differ -------------------------

@pytest.mark.parametrize("fresh", [True, False],
                         ids=["restarted_primary", "same_backend"])
@pytest.mark.parametrize("off,length", [(5000, 10000), (4096, 8192 + 7),
                                        (300, 100)])
def test_overwrite_keeps_the_tail_stripe(fresh, off, length):
    """The RMW pre-reads the head and the tail partial stripe apart; the
    bytes after the write in the tail stripe must survive (ceph_tpu's
    ECBackend drops that read when the head's is keyed at the extent's
    start, so a primary that did not write the object itself, with
    nothing in its extent cache, zeroes them)."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t, pg_t
    from ceph_tpu_torch.store import MemStore
    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "4", "m": "2", "device": "cpu"})
    store = MemStore()
    store.mount()

    def backend():
        return ECBackend(codec, StripeInfo(4096, 1024),
                         LocalShardBackend(store, pg_t(1, 0), 6))
    rng = np.random.default_rng(off + length)
    data = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    oid = hobject_t(pool=1, name="o")
    be = backend()
    txn = PGTransaction()
    txn.write(oid, 0, data.copy())
    be.submit_transaction(txn, eversion_t(1, 1), lambda: None)
    if fresh:
        be = backend()
    patch = rng.integers(0, 256, length, dtype=np.uint8)
    txn = PGTransaction()
    txn.write(oid, off, patch)
    op = be.submit_transaction(txn, eversion_t(1, 2), lambda: None)
    assert op.error is None
    data[off:off + length] = patch
    np.testing.assert_array_equal(backend().read(oid), data)


# -- boot: the prewarm and the library cache, read through the asok ---------

def test_boot_prewarm_and_cache_through_asok(tmp_path):
    from ceph_tpu_torch.common.admin_socket import admin_command
    from ceph_tpu_torch.ops import compile_cache, prewarm
    # both are once a process (the first enabler's directory, the first
    # booter's pass): start this boot from none, as a fresh process does
    compile_cache.reset_for_tests()
    prewarm.reset_for_tests()
    conf = {"osd_ec_prewarm_budget_s": 600.0}
    with Cluster(n_osds=2, device="cpu", prewarm=True, conf=conf,
                 compile_cache_dir=str(tmp_path / "cache"),
                 asok_dir=str(tmp_path)) as c:
        for osd in c.osds:
            path = str(tmp_path / f"osd.{osd.osd_id}.asok")
            st = admin_command(path, {"prefix": "prewarm status"})
            boot = st["boot"]
            assert "error" not in boot, boot
            assert boot["planned"] > 0 and boot["done"] == boot["planned"]
            assert boot["skipped"] == 0
            cache = st["persistent_cache"]
            assert cache["enabled"] and "error" not in cache
            assert cache["dir"] == str(tmp_path / "cache")
            ledger = admin_command(path, {"prefix": "compile ledger"})
            assert "error" not in ledger and ledger["osd"] == osd.osd_id
        # the second daemon reused the first one's pass (one a host)
        assert c.osds[1]._prewarm_status.get("reused")


# -- the cluster on a mesh (tests/test_mesh_service.py's cluster case) -------

def test_cluster_mesh_deployment_and_status():
    """osd_ec_use_mesh on the port: every OSD shares the host's
    MeshService (a 4x2 mesh of CPU devices here, as the reference's
    case runs on its 8 virtual CPU devices), EC PGs drain on the mesh
    plane, `mesh status` shows it, and a kill/revive keeps serving."""
    from ceph_tpu_torch.parallel.service import MeshService
    MeshService.reset()
    try:
        MeshService.configure("4x2", visible=["cpu"] * 8)
        run_case(ported("test_mesh_service"),
                 "test_cluster_mesh_deployment_and_status",
                 mesh_service=MeshService.get())
    finally:
        MeshService.reset()


# -- the persistent dispatch-ahead window and the deep-scrub asok ------------

def test_pipelined_window_and_deep_scrub_asok():
    conf = {"ec_dispatch_ahead": True, "ec_dispatch_ahead_depth": 2,
            "ec_dispatch_flush_ms": 1.0}
    rng = np.random.default_rng(21)
    with Cluster(n_osds=6, conf=conf, device="cpu") as c:
        cl = c.client()
        cl.set_ec_profile("pw", PROFILE)
        cl.create_pool("pwpool", "erasure", erasure_code_profile="pw",
                       pg_num=8)
        io = cl.open_ioctx("pwpool")
        blobs = {f"w{i}": rng.integers(0, 256, 3000 + 1024 * i,
                                       dtype=np.uint8).tobytes()
                 for i in range(16)}
        futs = [io.aio_write_full(k, v) for k, v in blobs.items()]
        for f in futs:
            f.result(timeout=30)
        for k, v in blobs.items():
            assert io.read(k, len(v)) == v
        submits = errors = scrubbed = host_bytes = 0
        for osd in c.osds:
            for pgid, st in osd.pgs.items():
                if st.kind == "ec":
                    assert st.backend._auto_flush_ms == 1.0
                    assert st.backend.inflight_ops() == []
            for name, counters in osd.cct.perf.dump().items():
                if name.startswith("ec.") and isinstance(counters, dict):
                    submits += int(counters.get("ec_drain_submits", 0))
            for pg, res in osd._asok_scrub({"deep": True}).items():
                errors += len(res["errors"])
                scrubbed += res["objects"]
                host_bytes += res.get("host_bytes", 0)
                assert res.get("device_bytes", 0) == 0   # the CPU
        assert submits > 0
        assert errors == 0 and scrubbed == len(blobs) and host_bytes > 0
        assert check_hinfo_crcs(c.osds) == len(blobs) * 6


# -- the same writes into a reference cluster and a port cluster -------------

def _drive(cluster, plugin):
    """The reference test's 20 objects (test_ec_pool_many_objects'
    sizes), an object create (no bytes: no launch on the port), an
    append and a partial overwrite."""
    cl = cluster.client()
    cl.set_ec_profile("par", dict(PROFILE, plugin=plugin))
    cl.create_pool("parpool", "erasure", erasure_code_profile="par",
                   pg_num=8)
    io = cl.open_ioctx("parpool")
    rng = np.random.default_rng(1)
    blobs = {}
    for i in range(20):
        blobs[f"many{i}"] = rng.integers(0, 256, 777 + 137 * i,
                                         dtype=np.uint8).tobytes()
        io.write_full(f"many{i}", blobs[f"many{i}"])
    io.create("empty")
    io.append("many3", b"\x5a" * 5000)
    io.write("many7", b"\xab" * 100, offset=300)
    for name, data in blobs.items():
        if name not in ("many3", "many7"):
            assert io.read(name, len(data)) == data
    assert io.stat("empty") == 0


def test_port_cluster_stores_what_reference_cluster_stores():
    with JCluster(n_osds=6) as jc, Cluster(n_osds=6, device="cpu") as tc:
        _drive(jc, "jax")
        _drive(tc, "torch")
        n = 0
        for j_osd, t_osd in zip(jc.osds, tc.osds):
            j_state = shard_state(j_osd.store)
            t_state = shard_state(t_osd.store)
            assert t_state.keys() == j_state.keys(), t_osd.osd_id
            for key, (j_bytes, j_hinfo) in j_state.items():
                t_bytes, t_hinfo = t_state[key]
                assert t_bytes == j_bytes, (t_osd.osd_id, key)
                assert t_hinfo == j_hinfo, (t_osd.osd_id, key)
                n += 1
        assert n >= 21 * 6
        assert check_hinfo_crcs(tc.osds) >= 20 * 6

"""The object service as a whole, on the CPU: chip_smoke.py's phase P
object traffic (`object_sequence`: buckets, objects PUT from client
threads, multipart uploads, a copy, versioning, a lifecycle sweep,
listings across a reshard, Swift, the OSD of data shard 1 of the first
object down and back, a gateway restart, notifications and a full and
an incremental sync to a second zone) at a small size, through a
reference cluster and gateway (`plugin=jax`) and a port cluster and
gateway (`plugin=torch` on the CPU), each with a second zone of its own
package and an erasure data pool of k=4 m=2.  Every response, listing,
version, event and zone must be equal, and the data pool's shards OSD
by OSD (objects under `_data_oid` names; version and part objects have
random ids, so they are held through their manifests and counts).
Also: the port's `rgw` daemon role survives a SIGKILL of its process
(tests/test_torch_object_zone.py opens a zone in the other package)."""

import types
import urllib.request

import numpy as np
import pytest

import ceph_tpu.rgw.sigv4 as jsigv4
import ceph_tpu.rgw.store as jstore
import ceph_tpu.rgw.sync as jsync
import ceph_tpu_torch.rgw.sigv4 as tsigv4
import ceph_tpu_torch.rgw.store as tstore
import ceph_tpu_torch.rgw.sync as tsync
import chip_smoke
from ceph_tpu.rgw import S3Gateway as JGateway
from ceph_tpu.tools.vstart import Cluster as JCluster
from ceph_tpu_torch.rgw import S3Gateway as TGateway
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster import shard_state
from test_torch_cluster_foundations import port_singletons  # noqa: F401

# phase P's mix at 64 KiB "big" objects (four stripes of k=4 x 4 KiB)
SIZES = {"buckets": 4, "big": (8, 64 << 10), "threads": 4,
         "small": (8, 4 << 10), "multipart": (2, 3, 40 << 10),
         "version": 64 << 10, "lifecycle": (4, 4 << 10), "page": 3,
         "reshard": 4, "swift": 64 << 10, "notify": (4, 64 << 10)}
PROFILE = {"k": "4", "m": "2", "technique": "cauchy", "stripe_unit": "4096"}
CREDS = {chip_smoke.RGW_ACCESS: chip_smoke.RGW_SECRET}
N_OSDS = 7
PACKAGES = {
    "jax": (JCluster, {}, JGateway,
            types.SimpleNamespace(sigv4=jsigv4, store=jstore, sync=jsync)),
    "torch": (Cluster, {"device": "cpu"}, TGateway,
              types.SimpleNamespace(sigv4=tsigv4, store=tstore,
                                    sync=tsync))}


def _data_pool(c, plugin, profile=PROFILE):
    cl = c.client()
    cl.set_ec_profile("rgw_ec", dict(profile, plugin=plugin))
    cl.create_pool(".rgw.data", "erasure", erasure_code_profile="rgw_ec",
                   pg_num=8)


def _run(c, zone_b, plugin, gw_cls, rgw):
    """object_sequence on `c` through its package's in-process gateway,
    `zone_b` the second zone; returns its result and step labels."""
    _data_pool(c, plugin)
    _data_pool(zone_b, plugin)
    client = c.client()
    gws = [gw_cls(client, creds=CREDS, ec_profile="rgw_ec")]

    def restart():
        gws[-1].shutdown()
        gws.append(gw_cls(client, creds=CREDS, ec_profile="rgw_ec"))
        return gws[-1].addr

    steps = []
    try:
        res = chip_smoke.object_sequence(
            gws[0].addr, rgw, client, c, lambda osd: None, restart,
            zone_b.client(), SIZES,
            lambda label, fn, nbytes, ops=0: (fn(), steps.append(label)))
    finally:
        gws[-1].shutdown()
    return res, steps


def test_object_service_stores_what_the_reference_stores():
    results, states = {}, {}
    for name, (cls, kw, gw_cls, rgw) in PACKAGES.items():
        with cls(n_osds=N_OSDS, **kw) as c, cls(n_osds=6, **kw) as zb:
            results[name] = _run(c, zb, name, gw_cls, rgw)
            states[name] = [shard_state(o.store) for o in c.osds]
    (tres, tsteps), (jres, jsteps) = results["torch"], results["jax"]
    assert tsteps == jsteps and len(tsteps) == 21
    # the receiver may get a record twice (at-least-once)
    assert tres.pop("event_records") >= SIZES["notify"][0]
    assert jres.pop("event_records") >= SIZES["notify"][0]
    for key in jres:
        assert tres[key] == jres[key], key
    assert len(tres["events"]) == SIZES["notify"][0]
    assert len(tres["responses"]) > 100
    assert tres["versions"][0][:3] == ("DeleteMarker", "ver/key", True)
    # the data pool's shards, OSD by OSD
    names = set(tres["data_oids"])
    n = 0
    for osd, (js, ts) in enumerate(zip(states["jax"], states["torch"])):
        named = {k for k in ts if any(nm in k[1] for nm in names)}
        assert named == {k for k in js if any(nm in k[1] for nm in names)}
        for k in named:
            assert ts[k] == js[k], (osd, k)
            n += 1
    assert n >= len(names) * 6 // 2
    # version and part objects have random names: the same count in all
    counts = {p: sum(1 for s in states[p] for k in s
                     if "vr_" in k[1] or "mp_" in k[1]) for p in states}
    assert counts["torch"] == counts["jax"] > 0


def test_rgw_role_survives_sigkill(tmp_path):
    """The `rgw` role of daemon_main through ProcCluster.spawn_rgw on a
    torch k=4 m=2 data pool: a bucket and a 4 MiB object PUT, read
    back; the gateway process SIGKILLed and spawned again serves the
    same bytes (its state lives in RADOS)."""
    from ceph_tpu_torch.tools.proc_cluster import ProcCluster
    blob = np.random.default_rng(37).integers(
        0, 256, (4 << 20) + 123, dtype=np.uint8).tobytes()
    with ProcCluster(n_osds=6, objectstore="bluestore", device="cpu",
                     data_dir=str(tmp_path / "d"),
                     heartbeat_interval=0.0) as c:
        _data_pool(c, "torch")
        host, port = c.spawn_rgw()
        base = f"http://{host}:{port}"
        for path, data in (("/pb", None), ("/pb/blob", blob)):
            with urllib.request.urlopen(urllib.request.Request(
                    base + path, data=data, method="PUT"), timeout=60) as r:
                assert r.status == 200
        with urllib.request.urlopen(base + "/pb/blob", timeout=60) as r:
            assert r.read() == blob
        proc = c.rgw_procs[-1]
        proc.kill()
        assert proc.wait() == -9
        host, port = c.spawn_rgw()
        with urllib.request.urlopen(f"http://{host}:{port}/pb/blob",
                                    timeout=60) as r:
            assert r.read() == blob
        pool = c.client().objecter.osdmap.lookup_pool(".rgw.data")
        assert pool.is_erasure() and pool.erasure_code_profile == "rgw_ec"
    assert (tmp_path / "d" / "rgw.log").exists()

"""The port's MeshService (ceph_tpu_torch/parallel/service.py) and the
ECBackend mesh plane against the JAX package's: the scenarios of
tests/test_mesh_service.py:34-365 replayed on both packages (the
cluster tests after them wait for the OSD daemon).  The JAX service
runs a 4x2 mesh of the 8 virtual CPU devices tests/conftest.py sets up,
the port's a 4x2 mesh of a repeated "cpu" device.  Shapes, errors,
bytes and the ec_mesh_* counters must be equal."""

import numpy as np
import pytest

import ceph_tpu.ec as jec
import ceph_tpu.osd.ec_backend as jbe
import ceph_tpu.osd.ec_transaction as ject
import ceph_tpu.osd.ec_util as jutil
import ceph_tpu.osd.types as jtypes
import ceph_tpu.parallel.service as jsvc
import ceph_tpu.store as jstore
import ceph_tpu.store.object_store as jos
import ceph_tpu_torch.ec as tec
import ceph_tpu_torch.osd.ec_backend as tbe
import ceph_tpu_torch.osd.ec_transaction as tect
import ceph_tpu_torch.osd.ec_util as tutil
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.parallel.service as tsvc
import ceph_tpu_torch.store as tstore
import ceph_tpu_torch.store.object_store as tos
from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue

MESH_COUNTERS = ("ec_mesh_drains", "ec_mesh_repair_launches",
                 "ec_mesh_errors")
CPU8 = ["cpu"] * 8


class Side:
    def __init__(self, port: bool):
        self.port = port
        (self.ec, self.be, self.ect, self.util, self.types, self.store,
         self.os, self.svc) = \
            (tec, tbe, tect, tutil, ttypes, tstore, tos, tsvc) if port \
            else (jec, jbe, ject, jutil, jtypes, jstore, jos, jsvc)

    def configure(self, spec=None):
        if self.port:
            return self.svc.MeshService.configure(spec, visible=CPU8)
        return self.svc.MeshService.configure(spec)

    def oid(self, name):
        return self.types.hobject_t(pool=1, name=name)

    def codec(self, k=4, m=2, plugin="jax", technique="cauchy"):
        prof = {"k": str(k), "m": str(m)}
        if plugin == "jax":
            prof["technique"] = technique
            if self.port:
                plugin = "torch"
                prof["device"] = "cpu"
        return self.ec.ErasureCodePluginRegistry.instance().factory(
            plugin, prof)

    def backend(self, codec, chunk=64, **kw):
        store = self.store.MemStore()
        store.mount()
        k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
        shards = self.be.LocalShardBackend(store, self.types.pg_t(1, 0), n)
        if self.port:
            kw["device"] = "cpu"
        return self.be.ECBackend(codec, self.util.StripeInfo(k * chunk,
                                                             chunk),
                                 shards, **kw), store

    def write(self, be, name, data):
        txn = self.ect.PGTransaction()
        txn.write(self.oid(name), 0, data)
        done = []
        be.submit_transaction(txn, self.types.eversion_t(1, 1),
                              lambda: done.append(1))
        assert done == [1]


SIDES = [Side(True), Side(False)]


@pytest.fixture()
def services():
    """Both packages' host services on a 4x2 mesh, reset around the
    test (and the port's host launch queue with them)."""
    for side in SIDES:
        side.svc.MeshService.reset()
    ECLaunchQueue.reset_host()
    try:
        yield {side.port: side.configure("4x2") for side in SIDES}
    finally:
        for side in SIDES:
            side.svc.MeshService.reset()
        ECLaunchQueue.reset_host()


def _counters(be):
    dump = be.perf.dump()
    return {c: dump[c] for c in MESH_COUNTERS}


# -- shape parsing / service lifecycle ---------------------------------------

@pytest.mark.parametrize("spec,want", [("4x2", (4, 2)), ("2X4", (2, 4)),
                                       ("8", (4, 2)), ("6", (2, 3)),
                                       ("", (4, 2)), ("3", (1, 3)),
                                       ("nope", None), ("0x2", None)])
def test_parse_mesh_shape_matches_jax(spec, want):
    for side in SIDES:
        if want is None:
            with pytest.raises(side.svc.MeshError):
                side.svc.parse_mesh_shape(spec, 8)
        else:
            assert side.svc.parse_mesh_shape(spec, 8) == want


def test_service_configure_status_idempotent(services):
    for side in SIDES:
        svc = services[side.port]
        st = svc.status()
        assert st["shape"] == {"shard": 4, "data": 2}
        assert st["n_devices"] == 8 and st["failures"] == 0
        assert side.configure("4x2") is svc
        assert side.configure() is svc
        assert side.svc.MeshService.get_or_configure("") is svc
        with pytest.raises(side.svc.MeshError):
            side.configure("2x2")
    st = services[True].status()
    assert st["gather"] == "local" and st["backend"] == "cpu"
    assert st["devices"] == ["cpu"] and st["devices_visible"] == 8


def test_service_needs_enough_devices():
    for side in SIDES:
        side.svc.MeshService.reset()
        try:
            with pytest.raises(side.svc.MeshError):
                side.configure("8x4")    # 32 > 8 visible
        finally:
            side.svc.MeshService.reset()


def test_service_default_devices_are_cuda(monkeypatch):
    """Without `visible`, the port's service counts CUDA devices: none
    here, so any shape is refused rather than built on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    tsvc.MeshService.reset()
    try:
        with pytest.raises(tsvc.MeshError, match="have 0"):
            tsvc.MeshService.configure("1")
    finally:
        tsvc.MeshService.reset()


# -- geometry-checked acquisition --------------------------------------------

def test_acquire_caching_and_mismatches(services):
    from ceph_tpu_torch.ec import gf
    for side in SIDES:
        svc = services[side.port]
        c1 = svc.acquire(4, 2)
        assert svc.acquire(4, 2, technique="cauchy") is c1
        assert svc.acquire(8, 3) is not c1
        assert "k=4 m=2 cauchy" in svc.status()["codecs"]
        assert "k=8 m=3 cauchy" in svc.status()["codecs"]
        with pytest.raises(side.svc.MeshError):
            svc.acquire(3, 2)           # 3 does not divide the shard axis
        with pytest.raises(side.svc.MeshError):
            svc.acquire(4, 2, technique="cauchy",
                        matrix=gf.vandermonde_rs_matrix(4, 2))
    np.testing.assert_array_equal(services[True].acquire(4, 2).matrix,
                                  services[False].acquire(4, 2).matrix)


def test_acquired_codec_matches_single_card(services):
    rng = np.random.default_rng(3)
    flat = rng.integers(0, 256, (4, 2048), dtype=np.uint8)
    got = {}
    for side in SIDES:
        codec = side.codec()
        dcodec = services[side.port].acquire(4, 2, matrix=codec.matrix)
        got[side.port] = dcodec.encode_flat(flat)
        np.testing.assert_array_equal(got[side.port],
                                      np.asarray(codec.encode_chunks(flat)))
    np.testing.assert_array_equal(got[True], got[False])


def test_decode_flat_batch_matches_per_object(services):
    k, m = 4, 2
    rng = np.random.default_rng(9)
    erased = (1, 4)
    survivors = tuple(s for s in range(k + m) if s not in erased)[:k]
    codec = SIDES[0].codec()
    avail_list, want = [], []
    for w in (512, 1024, 1536):
        d = rng.integers(0, 256, (k, w), dtype=np.uint8)
        full = np.concatenate([d, np.asarray(codec.encode_chunks(d))])
        avail_list.append(full[list(survivors)])
        want.append(full[list(erased)])
    for side in SIDES:
        dcodec = services[side.port].acquire(k, m)
        out = dcodec.decode_flat_batch(avail_list, survivors, erased)
        assert len(out) == 3
        for got, exp, av in zip(out, want, avail_list):
            np.testing.assert_array_equal(got, exp)
            np.testing.assert_array_equal(
                dcodec.decode_flat(av, survivors, erased), got)


# -- ECBackend acquisition + config-error fallback ---------------------------

def test_backend_acquires_from_service(services):
    data = np.random.default_rng(11).integers(0, 256, 1000, dtype=np.uint8)
    counts = {}
    for side in SIDES:
        be, _ = side.backend(side.codec(), mesh_service=services[side.port])
        assert be.mesh_codec is not None and be.mesh_error is None
        assert be.mesh_status() == {"active": True,
                                    "mesh": {"shard": 4, "data": 2},
                                    "error": None}
        side.write(be, "svc1", data)
        np.testing.assert_array_equal(be.read(side.oid("svc1"), 0, 1000),
                                      data)
        counts[side.port] = _counters(be)
    assert counts[True] == counts[False]
    assert counts[True]["ec_mesh_drains"] >= 1


def test_backend_geometry_error_falls_back(services):
    """k=3 does not divide the 4-wide shard axis: a logged, surfaced
    config error, and the backend serves from the single-device plane."""
    data = np.random.default_rng(13).integers(0, 256, 600, dtype=np.uint8)
    errors = {}
    for side in SIDES:
        logged = []
        be, _ = side.backend(side.codec(k=3, m=2),
                             mesh_service=services[side.port],
                             logger=logged.append)
        assert be.mesh_codec is None
        assert "shard axis" in be.mesh_error
        assert logged and "single-chip" in logged[0]
        assert be.mesh_status()["active"] is False
        side.write(be, "fb1", data)
        np.testing.assert_array_equal(be.read(side.oid("fb1"), 0, 600),
                                      data)
        assert _counters(be)["ec_mesh_drains"] == 0
        errors[side.port] = be.mesh_error
    assert errors[True] == errors[False]


def test_backend_rejects_mismatched_mesh_codecs(services):
    """An injected codec of another geometry, a doctored plugin matrix
    and a plugin with no matrix each leave the backend on the
    single-device plane with the reference's mesh_error."""
    errors = {}
    for side in SIDES:
        svc = services[side.port]
        be, _ = side.backend(side.codec(), mesh_codec=svc.acquire(8, 3))
        assert be.mesh_codec is None and "geometry" in be.mesh_error
        doctored = side.codec()
        doctored.matrix = doctored.matrix.copy()
        doctored.matrix[4, 0] ^= 1
        be2, _ = side.backend(doctored, mesh_service=svc)
        assert be2.mesh_codec is None and "matrix" in be2.mesh_error
        bare = side.codec()
        bare.matrix = None
        be3, _ = side.backend(bare, mesh_service=svc)
        assert be3.mesh_codec is None
        assert "no generator matrix" in be3.mesh_error
        errors[side.port] = (be.mesh_error, be3.mesh_error)
    assert errors[True] == errors[False]


def test_jerasure_reed_sol_van_rides_mesh(services):
    """jerasure reed_sol_van shares the vandermonde generator with the
    mesh codec, so the CPU-plugin pool scales onto the mesh plane."""
    data = np.random.default_rng(41).integers(0, 256, 1500, dtype=np.uint8)
    shards = {}
    for side in SIDES:
        be, store = side.backend(side.codec(plugin="jerasure"),
                                 mesh_service=services[side.port])
        assert be.mesh_codec is not None, be.mesh_error
        side.write(be, "jrs", data)
        np.testing.assert_array_equal(be.read(side.oid("jrs"), 0, 1500),
                                      data)
        assert _counters(be)["ec_mesh_drains"] == 1
        shards[side.port] = [store.read(be.shards.cids[s],
                                        side.ect.shard_oid(side.oid("jrs"),
                                                           s))
                             for s in range(6)]
    for a, b in zip(shards[True], shards[False]):
        np.testing.assert_array_equal(a, b)


# -- batched distributed recovery --------------------------------------------

def _write_objects(side, be, names, nbytes=1024, seed=17):
    rng = np.random.default_rng(seed)
    data = {}
    with be.batch():
        for i, name in enumerate(names):
            payload = rng.integers(0, 256, nbytes, dtype=np.uint8)
            data[name] = payload
            txn = side.ect.PGTransaction()
            txn.write(side.oid(name), 0, payload)
            be.submit_transaction(txn, side.types.eversion_t(1, i + 1),
                                  lambda: None)
    return data


def _drop_shards(side, be, store, name, shards):
    orig = {}
    for s in shards:
        goid = side.ect.shard_oid(side.oid(name), s)
        orig[s] = store.read(be.shards.cids[s], goid).copy()
        t = side.os.Transaction()
        t.remove(goid)
        store.queue_transactions(be.shards.cids[s], [t])
    return orig


def test_recover_shards_batch_one_mesh_launch(services):
    """A storm of objects missing the same shards rebuilds in ONE
    batched distributed decode, on both packages."""
    names = [f"storm{i}" for i in range(5)]
    got = {}
    for side in SIDES:
        be, store = side.backend(side.codec(),
                                 mesh_service=services[side.port])
        _write_objects(side, be, names)
        orig = {n: _drop_shards(side, be, store, n, (1, 4)) for n in names}
        before = _counters(be)["ec_mesh_repair_launches"]
        pushed = {n: {} for n in names}
        res = be.recover_shards_batch(
            [(side.oid(n), [1, 4]) for n in names],
            lambda o: lambda s, d, h: pushed[o.name].__setitem__(s, d))
        assert all(e is None for e in res.values()), res
        assert _counters(be)["ec_mesh_repair_launches"] == before + 1
        for n in names:
            for s in (1, 4):
                np.testing.assert_array_equal(pushed[n][s], orig[n][s])
        got[side.port] = (pushed, _counters(be))
    assert got[True][1] == got[False][1]


def test_recover_shards_batch_mixed_geometry(services):
    """Objects missing different shards group into separate launches but
    all rebuild; a hopeless object reports its error without blocking
    the rest."""
    got = {}
    for side in SIDES:
        be, store = side.backend(side.codec(),
                                 mesh_service=services[side.port])
        _write_objects(side, be, ["ga", "gb", "gc"], seed=23)
        orig = {"ga": _drop_shards(side, be, store, "ga", (0,)),
                "gb": _drop_shards(side, be, store, "gb", (2, 5))}
        _drop_shards(side, be, store, "gc", (0, 1, 2, 3, 4, 5))
        pushed = {n: {} for n in ("ga", "gb", "gc")}
        res = be.recover_shards_batch(
            [(side.oid("ga"), [0]), (side.oid("gb"), [2, 5]),
             (side.oid("gc"), [0, 1, 2, 3, 4, 5])],
            lambda o: lambda s, d, h: pushed[o.name].__setitem__(s, d))
        assert res[side.oid("ga")] is None
        assert res[side.oid("gb")] is None
        assert res[side.oid("gc")] is not None   # surfaced, not raised
        np.testing.assert_array_equal(pushed["ga"][0], orig["ga"][0])
        for s in (2, 5):
            np.testing.assert_array_equal(pushed["gb"][s], orig["gb"][s])
        got[side.port] = _counters(be)
    assert got[True] == got[False]
    assert got[True]["ec_mesh_repair_launches"] == 2


def test_recovery_mesh_failure_falls_back(services):
    """A mesh failure mid-recovery is contained: the plane is disabled,
    the same batch completes on the single-device plane, and the
    service ledger records the failure — with equal counters on both
    packages."""
    got = {}
    for side in SIDES:
        svc = services[side.port]
        be, store = side.backend(side.codec(), mesh_service=svc)
        names = ["rf0", "rf1"]
        _write_objects(side, be, names, seed=29)
        orig = {n: _drop_shards(side, be, store, n, (2,)) for n in names}

        def boom(*a, **kw):
            raise RuntimeError("injected mesh decode failure")
        mc = be.mesh_codec
        be.mesh_codec = type(mc)(mc.k, mc.m, mc.mesh)
        be.mesh_codec.decode_flat_batch = boom
        pushed = {n: {} for n in names}
        res = be.recover_shards_batch(
            [(side.oid(n), [2]) for n in names],
            lambda o: lambda s, d, h: pushed[o.name].__setitem__(s, d))
        assert all(e is None for e in res.values()), res
        for n in names:
            np.testing.assert_array_equal(pushed[n][2], orig[n][2])
        assert be.mesh_codec is None
        assert "disabled after failure" in be.mesh_error
        assert svc.failures == 1
        assert "injected mesh decode failure" in svc.last_error
        got[side.port] = _counters(be)
    assert got[True] == got[False]
    assert got[True]["ec_mesh_errors"] == 1


def test_drain_mesh_failure_aborts_op_and_falls_back(services):
    """A mesh launch that fails in a drain aborts that op; the next
    write takes the single-device plane and reads back."""
    data = np.random.default_rng(31).integers(0, 256, 512, dtype=np.uint8)
    for side in SIDES:
        svc = services[side.port]
        be, _ = side.backend(side.codec(), mesh_service=svc)

        def boom(*a, **kw):
            raise RuntimeError("injected mesh encode failure")
        mc = be.mesh_codec
        be.mesh_codec = type(mc)(mc.k, mc.m, mc.mesh)
        be.mesh_codec.encode_flat_submit = boom
        txn = side.ect.PGTransaction()
        txn.write(side.oid("d0"), 0, data)
        acks = []
        be.submit_transaction(txn, side.types.eversion_t(1, 1),
                              lambda *a: acks.append(a))
        assert be.mesh_codec is None and svc.failures == 1
        assert _counters(be) == {"ec_mesh_drains": 0,
                                 "ec_mesh_repair_launches": 0,
                                 "ec_mesh_errors": 1}
        side.write(be, "d1", data)
        np.testing.assert_array_equal(be.read(side.oid("d1"), 0, 512), data)

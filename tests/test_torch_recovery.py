"""Recovery in the port (ceph_tpu_torch/osd/ec_backend.py) against the
JAX package's: the scenarios of tests/test_repair.py (but the mesh and
mClock cases, which wait for the mesh plane and the OSD scheduler) and
the recover_shard cases of tests/test_ec_pipeline.py, replayed on both
sides.  The same objects are written through both backends and the same
shards lost; rebuilt shards must equal the originals and the JAX
backend's, with the same pushed HashInfo, the same ec_repair_* /
ec_clay_* counters and the same per-object error set.  Pools: torch k=8
m=3 (jax on the JAX side), CLAY k=8 m=4 d=11 and k=4 m=2 d=5, LRC and
SHEC.  Every queue is built by its test and closed."""

import time

import numpy as np
import pytest

import ceph_tpu.ec as jec
import ceph_tpu.osd.ec_backend as jbe
import ceph_tpu.osd.ec_transaction as ject
import ceph_tpu.osd.ec_util as jutil
import ceph_tpu.osd.types as jtypes
import ceph_tpu.parallel.launch_queue as jlq
import ceph_tpu.parallel.mesh as jmesh
import ceph_tpu.store as jstore
import ceph_tpu.store.object_store as jos
import ceph_tpu_torch.ec as tec
import ceph_tpu_torch.osd.ec_backend as tbe
import ceph_tpu_torch.osd.ec_transaction as tect
import ceph_tpu_torch.osd.ec_util as tutil
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.parallel.launch_queue as tlq
import ceph_tpu_torch.parallel.mesh as tmesh
import ceph_tpu_torch.store as tstore
import ceph_tpu_torch.store.object_store as tos

REPAIR_COUNTERS = ("helper_bytes_read", "reconstructed_bytes",
                   "clay_repairs", "clay_repair_launches",
                   "clay_repair_fallbacks", "clay_plans_cached",
                   "reconstruct_reads", "reconstruct_read_bytes",
                   "read_timeouts")


def _instrumented(base):
    class InstrumentedShards(base):
        """`down` shards fail reads synchronously, `mute` shards never
        answer; read bytes are counted."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.down: set[int] = set()
            self.mute: set[int] = set()
            self.read_bytes = 0

        def sub_read(self, shard, oid, off, length, on_done):
            if shard in self.mute:
                return
            if shard in self.down:
                on_done(shard, None)
                return
            self.read_bytes += length
            super().sub_read(shard, oid, off, length, on_done)
    return InstrumentedShards


class Side:
    def __init__(self, port: bool):
        self.port = port
        (self.ec, self.be, self.ect, self.util, self.types, self.store,
         self.os, self.lq, self.mesh) = \
            (tec, tbe, tect, tutil, ttypes, tstore, tos, tlq, tmesh) if port \
            else (jec, jbe, ject, jutil, jtypes, jstore, jos, jlq, jmesh)
        self.queues = []

    def codec(self, plugin, profile):
        prof = {k: str(v) for k, v in profile.items()}
        if plugin == "jax" and self.port:
            plugin = "torch"
        if plugin == "torch":
            prof["device"] = "cpu"
        return self.ec.ErasureCodePluginRegistry.instance().factory(
            plugin, prof)

    def queue(self, **kw):
        if self.port:
            kw["device"] = "cpu"
        q = self.lq.ECLaunchQueue(**kw)
        self.queues.append(q)
        return q

    def backend(self, plugin, profile, chunk=1024, queue=None, pg=0, **kw):
        codec = self.codec(plugin, profile)
        k = codec.get_data_chunk_count()
        store = self.store.MemStore()
        store.mount()
        shards = _instrumented(self.be.LocalShardBackend)(
            store, self.types.pg_t(1, pg), codec.get_chunk_count())
        if self.port:
            kw["device"] = "cpu"
        be = self.be.ECBackend(codec, self.util.StripeInfo(k * chunk, chunk),
                               shards, launch_queue=queue, **kw)
        return be, shards, store

    def oid(self, name):
        return self.types.hobject_t(pool=1, name=name)

    def write(self, be, name, payload, ver):
        acked = []
        txn = self.ect.PGTransaction()
        txn.write(self.oid(name), 0, payload)
        be.submit_transaction(txn, self.types.eversion_t(1, ver),
                              lambda: acked.append(1))
        assert acked, f"write {name} not acked"
        return self.oid(name)

    def kill(self, store, shards, oid, s):
        goid = self.ect.shard_oid(oid, s)
        orig = store.read(shards.cids[s], goid).copy()
        t = self.os.Transaction()
        t.remove(goid)
        store.queue_transactions(shards.cids[s], [t])
        return orig

    def recover(self, be, items):
        pushed = {}
        res = be.recover_shards_batch(
            items, lambda o: (lambda s, data, h, o=o: pushed.__setitem__(
                (o.name, s), (np.asarray(data).copy(), h.encode()))))
        return {o.name: e for o, e in res.items()}, pushed

    def close(self):
        for q in self.queues:
            q.close()


@pytest.fixture()
def sides():
    made = [Side(False), Side(True)]
    yield made
    for s in made:
        s.close()


def _repair_counters(be):
    st = be.repair_status()
    return {k: st[k] for k in REPAIR_COUNTERS}


def _errors(res):
    return {name for name, e in res.items() if e is not None}


# -- the launch queue's decode and CLAY repair kinds -------------------------

def test_queue_decode_coalesces_across_pgs(sides):
    rng = np.random.default_rng(3)
    inputs = [rng.integers(0, 256, (4, w), dtype=np.uint8) for w in (512, 256)]
    got = []
    for side in sides:
        q = side.queue(window_us=1e6)
        p1, p2 = (side.codec("jax", {"k": 4, "m": 2}) for _ in "ab")
        fulls, tickets = [], []
        for owner, (p, d) in enumerate(zip((p1, p2), inputs)):
            full = np.concatenate([d, np.asarray(p.encode_chunks(d))])
            dense = full.copy()
            dense[[1, 5]] = 0
            fulls.append(full)
            tickets.append(q.submit_decode(p, dense, [1, 5], owner=owner))
        for t, full in zip(tickets, fulls):
            np.testing.assert_array_equal(np.asarray(t.result()), full)
        st = q.status()
        got.append({k: st[k] for k in ("decode_launches", "cross_pg_launches",
                                       "launches")})
    assert got[1] == got[0] == {"decode_launches": 1, "cross_pg_launches": 1,
                                "launches": 1}


def test_queue_decode_different_erasures_never_cobatch(sides):
    rng = np.random.default_rng(4)
    d = rng.integers(0, 256, (4, 256), dtype=np.uint8)
    got = []
    for side in sides:
        q = side.queue(window_us=1e6)
        p = side.codec("jax", {"k": 4, "m": 2})
        full = np.concatenate([d, np.asarray(p.encode_chunks(d))])
        da, db = full.copy(), full.copy()
        da[0] = 0
        db[3] = 0
        ta = q.submit_decode(p, da, [0], owner=1)
        tb = q.submit_decode(p, db, [3], owner=1)
        np.testing.assert_array_equal(np.asarray(ta.result()), full)
        np.testing.assert_array_equal(np.asarray(tb.result()), full)
        got.append(q.status()["decode_launches"])
    assert got == [2, 2]


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (8, 4, 11)])
def test_queue_clay_repair_coalesces_on_plan_signature(sides, k, m, d):
    lost, ss = 1, 32
    outs = []
    for side in sides:
        q = side.queue(window_us=1e6)
        clay = side.codec("clay", {"k": k, "m": m, "d": d})
        n, sub = k + m, clay.get_sub_chunk_count()
        kw = {"device": "cpu"} if side.port else {}
        # a plan a PG: equal signatures coalesce
        plans = [side.mesh.ClayRepairPlan.build(clay, lost, **kw)
                 for _ in range(2)]
        planes = clay.repair_planes(lost)
        tickets, refs = [], []
        for i, plan in enumerate(plans):
            payload = np.random.default_rng(10 + i).integers(
                0, 256, k * sub * ss, dtype=np.uint8).tobytes()
            enc = clay.encode(set(range(n)), payload)
            helpers = {ch: np.asarray(enc[ch]).reshape(sub, ss)[planes]
                       for ch in plan.helper_ids}
            tickets.append(q.submit_clay_repair(
                plan, clay.repair_rows(lost, helpers), owner=i))
            refs.append(np.asarray(enc[lost]))
        res = [np.asarray(t.result()).reshape(-1) for t in tickets]
        for r, ref in zip(res, refs):
            np.testing.assert_array_equal(r, ref)
        st = q.status()
        outs.append((res, st["repair_launches"], st["cross_pg_launches"]))
    for a, b in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(a, b)
    assert outs[1][1:] == outs[0][1:] == (1, 1)


# -- reconstruct-on-read -------------------------------------------------------

def test_reconstruct_on_read_via_batched_decode(sides):
    rng = np.random.default_rng(7)
    payloads = [rng.integers(0, 256, 8 * 1024 * 2, dtype=np.uint8)
                for _ in range(3)]
    got = []
    for side in sides:
        q = side.queue(window_us=500.0)
        be, shards, _ = side.backend("jax", {"k": 8, "m": 3}, queue=q,
                                     read_timeout=5.0)
        oids = [side.write(be, f"o{i}", p, i + 1)
                for i, p in enumerate(payloads)]
        shards.down = {2}
        t0 = time.perf_counter()
        for oid, p in zip(oids, payloads):
            np.testing.assert_array_equal(be.read(oid), p)
        assert time.perf_counter() - t0 < 4.0
        st = _repair_counters(be)
        assert st["reconstruct_reads"] == 3 and st["read_timeouts"] == 0
        got.append((st, q.status()["decode_launches"]))
    assert got[1] == got[0]
    assert got[1][1] >= 1


def test_read_timeout_and_counter(sides):
    rng = np.random.default_rng(8)
    p = rng.integers(0, 256, 4 * 1024, dtype=np.uint8)
    got = []
    for side in sides:
        be, shards, _ = side.backend("jax", {"k": 4, "m": 2},
                                     read_timeout=0.3)
        oid = side.write(be, "t0", p, 1)
        shards.mute = {1}
        t0 = time.perf_counter()
        np.testing.assert_array_equal(be.read(oid), p)
        assert 0.25 <= time.perf_counter() - t0 < 2.0
        got.append(_repair_counters(be))
    assert got[1] == got[0]
    assert got[1]["read_timeouts"] == 1 and got[1]["reconstruct_reads"] == 1


def test_partial_degraded_read_offsets(sides):
    rng = np.random.default_rng(9)
    p = rng.integers(0, 256, 4 * 1024 * 3, dtype=np.uint8)
    got = []
    for side in sides:
        be, shards, _ = side.backend("jax", {"k": 4, "m": 2})
        oid = side.write(be, "p0", p, 1)
        shards.down = {0, 3}
        for off, ln in ((0, 100), (4096, 4096), (5000, 2500),
                        (len(p) - 7, 7)):
            np.testing.assert_array_equal(be.read(oid, off, ln),
                                          p[off:off + ln])
        got.append(_repair_counters(be))
    assert got[1] == got[0]
    assert got[1]["reconstruct_reads"] == 4


# -- batched recovery across pools --------------------------------------------

POOLS = {
    "torch_k8m3": ("jax", {"k": 8, "m": 3}, 1024),
    "clay_k8m4d11": ("clay", {"k": 8, "m": 4, "d": 11}, 4096),
    "clay_k4m2d5": ("clay", {"k": 4, "m": 2, "d": 5}, 1024),
    "lrc_k4m2l3": ("lrc", {"k": 4, "m": 2, "l": 3}, 1024),
    "lrc_k8m4l4": ("lrc", {"k": 8, "m": 4, "l": 4}, 1024),
    "shec_k4m3c2": ("shec", {"k": 4, "m": 3, "c": 2}, 1024),
    "shec_k8m4c3": ("shec", {"k": 8, "m": 4, "c": 3}, 1024),
}


def _lose_patterns(codec):
    n = codec.get_chunk_count()
    return [(0,), (n - 1,), (1, n - 2)]


@pytest.mark.parametrize("queued", [False, True], ids=["direct", "queued"])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_recover_shards_batch_matches_jax(sides, pool, queued):
    """Three objects (one of a single stripe, two of several) written
    through both backends; for each loss pattern the lost shards are
    removed and recovered in one batch: rebuilt bytes equal the lost
    bytes and the JAX backend's, pushed HashInfo and repair counters
    equal, and the same objects fail (none here)."""
    plugin, profile, chunk = POOLS[pool]
    rng = np.random.default_rng(len(pool))
    probe = sides[1].codec(plugin, profile)
    k = probe.get_data_chunk_count()
    payloads = [rng.integers(0, 256, k * chunk * s, dtype=np.uint8)
                for s in (1, 2, 3)]
    for missing in _lose_patterns(probe):
        outs = []
        for side in sides:
            q = side.queue(window_us=1e6) if queued else None
            be, shards, store = side.backend(plugin, profile, chunk, queue=q)
            oids = [side.write(be, f"o{i}", p, i + 1)
                    for i, p in enumerate(payloads)]
            lost = {(o.name, s): side.kill(store, shards, o, s)
                    for o in oids for s in missing}
            shards.read_bytes = 0
            res, pushed = side.recover(be, [(o, list(missing)) for o in oids])
            for key, want in lost.items():
                np.testing.assert_array_equal(pushed[key][0], want,
                                              err_msg=f"{pool} {key}")
            outs.append((res, pushed, _repair_counters(be), shards.read_bytes,
                         q.status()["launches"] if q else None))
        (jres, jpush, jst, jread, jl), (tres, tpush, tst, tread, tl) = outs
        assert _errors(tres) == _errors(jres) == set(), (pool, tres)
        assert tpush.keys() == jpush.keys()
        for key in jpush:
            np.testing.assert_array_equal(tpush[key][0], jpush[key][0])
            assert tpush[key][1] == jpush[key][1], key       # HashInfo
        assert tst == jst, (pool, missing)
        assert tread == jread
        if pool.startswith("clay") and len(missing) == 1:
            assert tst["clay_repairs"] == len(payloads)


def test_recover_submit_and_finalize_halves_match_batch(sides):
    """recover_shards_submit of two PGs before either's finalize (a
    storm's order) rebuilds what recover_shards_batch does, in one
    cross-PG decode launch; recover_shards_batch, PG after PG, launches
    once a PG, as the JAX backend's does.  A slice over
    RECOVER_BATCH_MAX objects is refused."""
    rng = np.random.default_rng(31)
    payloads = [rng.integers(0, 256, 8 * 1024, dtype=np.uint8)
                for _ in range(3)]
    port = sides[1]
    q = port.queue(window_us=1e6)
    results = []
    for split in (False, True):
        pgs = [port.backend("jax", {"k": 8, "m": 3}, queue=q, pg=p)
               for p in range(2)]
        items, lost = [], {}
        for p, (be, shards, store) in enumerate(pgs):
            oids = [port.write(be, f"o{i}", x, i + 1)
                    for i, x in enumerate(payloads)]
            for o in oids:
                lost[(p, o.name)] = port.kill(store, shards, o, 4)
            items.append([(o, [4]) for o in oids])
        before = q.status()
        pushed = {}

        def sink(p):
            return lambda o: (lambda s, d, h: pushed.__setitem__(
                (p, o.name), np.asarray(d).copy()))
        if split:
            recs = [be.recover_shards_submit(its, sink(p))
                    for p, ((be, _, _), its) in enumerate(zip(pgs, items))]
            res = [be.recover_shards_finalize(r)
                   for (be, _, _), r in zip(pgs, recs)]
        else:
            res = [be.recover_shards_batch(its, sink(p))
                   for p, ((be, _, _), its) in enumerate(zip(pgs, items))]
        assert all(e is None for r in res for e in r.values())
        for key, want in lost.items():
            np.testing.assert_array_equal(pushed[key], want)
        st = q.status()
        results.append((st["decode_launches"] - before["decode_launches"],
                        st["cross_pg_launches"] - before["cross_pg_launches"]))
    assert results == [(2, 0), (1, 1)]
    with pytest.raises(ValueError, match="at most 64"):
        pgs[0][0].recover_shards_submit(
            [(port.oid(f"x{i}"), [0]) for i in range(65)], sink(0))


def test_recovery_slices_at_recover_batch_max(sides):
    """More objects than RECOVER_BATCH_MAX recover in slices; the decode
    launches (4 KiB chunks, width-capped at DECODE_MAX_LAUNCH_W: 16
    objects a launch) equal the JAX backend's."""
    rng = np.random.default_rng(12)
    n_obj = 70
    payloads = [rng.integers(0, 256, 4 * 4096, dtype=np.uint8)
                for _ in range(n_obj)]
    got = []
    for side in sides:
        assert side.be.ECBackend.RECOVER_BATCH_MAX == 64
        q = side.queue(window_us=1e6)
        be, shards, store = side.backend("jax", {"k": 4, "m": 2}, queue=q)
        oids = [side.write(be, f"o{i}", p, i + 1)
                for i, p in enumerate(payloads)]
        for o in oids:
            side.kill(store, shards, o, 0)
        res, pushed = side.recover(be, [(o, [0]) for o in oids])
        assert _errors(res) == set() and len(pushed) == n_obj
        got.append((q.status()["decode_launches"], _repair_counters(be)))
    assert got[1] == got[0]
    assert got[1][0] == 5       # 64 objects: 4 launches; then 6 more: 1


# -- CLAY plane-read recovery -------------------------------------------------

def test_clay_recovery_reads_only_repair_planes(sides):
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, 4 * 1024, dtype=np.uint8)
                for _ in range(3)]
    outs = []
    for side in sides:
        be, shards, store = side.backend("clay", {"k": 4, "m": 2, "d": 5})
        codec = be.ec_impl
        oids = [side.write(be, f"c{i}", p, i + 1)
                for i, p in enumerate(payloads)]
        origs = {o.name: side.kill(store, shards, o, 2) for o in oids}
        shards.read_bytes = 0
        res, pushed = side.recover(be, [(o, [2]) for o in oids])
        assert _errors(res) == set()
        for name, orig in origs.items():
            np.testing.assert_array_equal(pushed[(name, 2)][0], orig)
        sub = codec.get_sub_chunk_count()
        planes = len(codec.repair_planes(2))
        expect = len(oids) * codec.d * planes * (1024 // sub)
        assert shards.read_bytes == expect
        st = be.repair_status()
        assert st["clay_repairs"] == 3 and st["clay_repair_launches"] == 1
        assert st["helper_bytes_read"] == expect
        outs.append((_repair_counters(be), pushed))
    assert outs[1][0] == outs[0][0]
    for key in outs[0][1]:
        np.testing.assert_array_equal(outs[1][1][key][0], outs[0][1][key][0])


def test_clay_recovery_falls_back_on_helper_failure(sides):
    rng = np.random.default_rng(12)
    p = rng.integers(0, 256, 4 * 1024, dtype=np.uint8)
    got = []
    for side in sides:
        be, shards, store = side.backend("clay", {"k": 4, "m": 2, "d": 5},
                                         read_timeout=2.0)
        oid = side.write(be, "f0", p, 1)
        orig = side.kill(store, shards, oid, 2)
        shards.down = {4}
        res, pushed = side.recover(be, [(oid, [2])])
        assert res["f0"] is None
        np.testing.assert_array_equal(pushed[("f0", 2)][0], orig)
        got.append(_repair_counters(be))
    assert got[1] == got[0]
    assert got[1]["clay_repair_fallbacks"] == 1 and got[1]["clay_repairs"] == 0


def test_clay_multi_shard_loss_uses_full_decode(sides):
    rng = np.random.default_rng(13)
    p = rng.integers(0, 256, 4 * 1024, dtype=np.uint8)
    got = []
    for side in sides:
        be, shards, store = side.backend("clay", {"k": 4, "m": 2, "d": 5})
        oid = side.write(be, "m0", p, 1)
        o1 = side.kill(store, shards, oid, 1)
        o4 = side.kill(store, shards, oid, 4)
        res, pushed = side.recover(be, [(oid, [1, 4])])
        assert res["m0"] is None
        np.testing.assert_array_equal(pushed[("m0", 1)][0], o1)
        np.testing.assert_array_equal(pushed[("m0", 4)][0], o4)
        got.append(_repair_counters(be))
    assert got[1] == got[0] and got[1]["clay_repairs"] == 0


def test_clay_queued_repair_through_plan_on_backend_device():
    """With a queue wired, a CLAY pool's repair takes the queue's "r"
    kind through a plan built on the backend's device, and a backend
    whose codec has no device of its own takes the one it is given."""
    port = Side(True)
    try:
        q = port.queue(window_us=1e6)
        be, shards, store = port.backend("clay", {"k": 8, "m": 4, "d": 11},
                                         4096, queue=q)
        assert str(be.device) == "cpu"
        rng = np.random.default_rng(14)
        oids = [port.write(be, f"q{i}", rng.integers(
            0, 256, 8 * 4096, dtype=np.uint8), i + 1) for i in range(2)]
        lost = {o.name: port.kill(store, shards, o, 5) for o in oids}
        res, pushed = port.recover(be, [(o, [5]) for o in oids])
        assert _errors(res) == set()
        for name, want in lost.items():
            np.testing.assert_array_equal(pushed[(name, 5)][0], want)
        assert q.status()["repair_launches"] == 1
        plan, = be._clay_plans.values()
        assert str(plan.device) == "cpu"
    finally:
        port.close()


def test_clay_drain_of_several_objects_recovers():
    """A CLAY pool's drain of several objects encodes each run alone
    (a sub-chunked code's planes span the run it encodes): the stored
    parity is every object's own and recovery passes its crc check.
    The JAX backend encodes the drain's runs concatenated, so its
    recovery of those objects fails the crc check."""
    results = []
    for side in (Side(False), Side(True)):
        be, shards, store = side.backend("clay", {"k": 4, "m": 2, "d": 5})
        rng = np.random.default_rng(15)
        with be.batch():
            oids = []
            for i in range(2):
                txn = side.ect.PGTransaction()
                oids.append(side.oid(f"b{i}"))
                txn.write(oids[-1], 0, rng.integers(0, 256, 4 * 1024,
                                                    dtype=np.uint8))
                be.submit_transaction(txn, side.types.eversion_t(1, i + 1),
                                      lambda: None)
        lost = {o.name: side.kill(store, shards, o, 5) for o in oids}
        res, pushed = side.recover(be, [(o, [5]) for o in oids])
        results.append(_errors(res))
        if side.port:
            for name, want in lost.items():
                np.testing.assert_array_equal(pushed[(name, 5)][0], want)
    assert results == [{"b0", "b1"}, set()]


# -- recover_shard (tests/test_ec_pipeline.py) ---------------------------------

def test_recover_shard_rebuilds_lost_shards(sides):
    rng = np.random.default_rng(2)
    payload = rng.integers(0, 256, 1024, dtype=np.uint8)
    outs = []
    for side in sides:
        be, shards, store = side.backend("jax", {"k": 4, "m": 2}, chunk=64)
        oid = side.write(be, "obj6", payload, 1)
        ref = {s: side.kill(store, shards, oid, s) for s in (1, 4)}
        pushed = {}
        be.recover_shard(oid, [1, 4],
                         lambda s, data, hinfo: pushed.__setitem__(
                             s, (np.asarray(data).copy(), hinfo.encode())))
        for s in (1, 4):
            np.testing.assert_array_equal(pushed[s][0], ref[s])
        outs.append(pushed)
    for s in (1, 4):
        np.testing.assert_array_equal(outs[1][s][0], outs[0][s][0])
        assert outs[1][s][1] == outs[0][s][1]


def test_recovery_crc_detects_corruption(sides):
    for side in sides:
        be, shards, store = side.backend("jax", {"k": 4, "m": 2}, chunk=64)
        oid = side.write(be, "obj7", np.zeros(1024, dtype=np.uint8), 1)
        t = side.os.Transaction()
        t.write(side.ect.shard_oid(oid, 2), 0,
                np.full(10, 0xEE, dtype=np.uint8))
        store.queue_transactions(shards.cids[2], [t])
        side.kill(store, shards, oid, 1)
        with pytest.raises(side.ec.ErasureCodeError, match="crc mismatch"):
            be.recover_shard(oid, [1], lambda *a: None)


def test_recover_reports_unrecoverable_objects_like_jax(sides):
    """An object without k survivors and one with no survivor at all
    fail alone; the rest of the batch recovers."""
    rng = np.random.default_rng(16)
    payloads = [rng.integers(0, 256, 4 * 64 * 2, dtype=np.uint8)
                for _ in range(3)]
    got = []
    for side in sides:
        be, shards, store = side.backend("jax", {"k": 4, "m": 2}, chunk=64)
        oids = [side.write(be, f"u{i}", p, i + 1)
                for i, p in enumerate(payloads)]
        for s in (0, 1, 2):                    # u0 keeps only 3 shards
            side.kill(store, shards, oids[0], s)
        res, pushed = side.recover(
            be, [(oids[0], [0]), (oids[1], [0]),
                 (side.oid("ghost"), [0])])
        got.append((_errors(res), sorted(pushed), _repair_counters(be)))
    assert got[1] == got[0]
    assert got[1][0] == {"u0", "ghost"}


def test_recovery_attrs_match_jax():
    data = np.arange(256, dtype=np.uint8)
    for invalidated in (False, True):
        jh = jutil.HashInfo.make(6)
        th = tutil.HashInfo.make(6)
        if invalidated:
            jh.invalidate()
            th.invalidate()
        assert tutil.recovery_attrs(th, data) == jutil.recovery_attrs(jh, data)
    si_j, si_t = jutil.StripeInfo(4096, 1024), tutil.StripeInfo(4096, 1024)
    for off in (0, 1, 4095, 4096, 10000):
        assert si_t.logical_to_prev_chunk_offset(off) == \
            si_j.logical_to_prev_chunk_offset(off)

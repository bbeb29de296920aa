"""The port's per-host launch queue (ceph_tpu_torch/parallel/
launch_queue.py) against the JAX package's: every scenario of
tests/test_launch_queue.py but the cluster/asok one (it needs the
daemon), replayed on both sides with the same seeded payloads.  The
JAX side runs plugin `jax` (or `jerasure`) on the CPU, the port's
plugin `torch` with device="cpu" (or its `jerasure`) and a queue on
the CPU.  Per-ticket results, shard bytes and HashInfo must be equal,
and so must `launches`, `decode_launches`, `repair_launches`,
`cross_pg_launches` and the retry/error counters.  Every queue is
built by its test and closed, so no window worker outlives it."""

import threading
import time

import numpy as np
import pytest
import torch

import ceph_tpu.ec as jec
import ceph_tpu.osd.ec_backend as jbe
import ceph_tpu.osd.ec_transaction as ject
import ceph_tpu.osd.ec_util as jutil
import ceph_tpu.osd.types as jtypes
import ceph_tpu.parallel.launch_queue as jlq
import ceph_tpu.store as jstore
import ceph_tpu_torch.ec as tec
import ceph_tpu_torch.osd.ec_backend as tbe
import ceph_tpu_torch.osd.ec_transaction as tect
import ceph_tpu_torch.osd.ec_util as tutil
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.parallel.launch_queue as tlq
import ceph_tpu_torch.store as tstore

# a window long enough that the timer never fires on its own: launches
# happen via byte cap or flush-on-demand
WIN_NEVER = 60_000_000.0
COUNTERS = ("launches", "decode_launches", "repair_launches",
            "cross_pg_launches", "launch_retries", "launch_errors",
            "coalesced_runs", "submissions", "pending_submissions")


class Side:
    """One package: its registry, backend classes and queue module."""

    def __init__(self, port: bool):
        self.port = port
        self.ec, self.be, self.ect, self.util, self.types, self.store, \
            self.lq = (tec, tbe, tect, tutil, ttypes, tstore, tlq) if port \
            else (jec, jbe, ject, jutil, jtypes, jstore, jlq)
        self.queues = []

    def queue(self, **kw):
        if self.port:
            kw.setdefault("device", "cpu")
        q = self.lq.ECLaunchQueue(**kw)
        self.queues.append(q)
        return q

    def codec(self, plugin, k=4, m=2, **extra):
        prof = {"k": str(k), "m": str(m), **extra}
        if plugin == "jax" and self.port:
            plugin = "torch"
        if plugin == "torch":
            prof["device"] = "cpu"
        return self.ec.ErasureCodePluginRegistry.instance().factory(
            plugin, prof)

    def backend(self, pg, queue, plugin="jerasure", k=4, m=2, chunk=64,
                shards_cls=None):
        codec = self.codec(plugin, k, m)
        store = self.store.MemStore()
        store.mount()
        shards = (shards_cls or self.be.LocalShardBackend)(
            store, self.types.pg_t(1, pg), k + m)
        kw = {"device": "cpu"} if self.port else {}
        return self.be.ECBackend(codec, self.util.StripeInfo(k * chunk, chunk),
                                 shards, launch_queue=queue,
                                 perf_name=f"ec.1.{pg}", **kw)

    def oid(self, name):
        return self.types.hobject_t(pool=1, name=name)

    def submit(self, be, name, off, payload, version, acks=None, tag=None):
        txn = self.ect.PGTransaction()
        txn.write(self.oid(name), off, payload)
        return be.submit_transaction(
            txn, self.types.eversion_t(1, version),
            (lambda: acks.append(tag)) if acks is not None else (lambda: None))

    def close(self):
        for q in self.queues:
            q.close()


@pytest.fixture()
def sides():
    made = [Side(False), Side(True)]
    yield made
    for s in made:
        s.close()


def _counters(q):
    st = q.status()
    return {c: st[c] for c in COUNTERS}


def _shards_equal(jside, jbackend, tside, tbackend, name):
    jo, to = jside.oid(name), tside.oid(name)
    for s in range(jbackend.n):
        jg, tg = ject.shard_oid(jo, s), tect.shard_oid(to, s)
        np.testing.assert_array_equal(
            tbackend.shards.store.read(tbackend.shards.cids[s], tg),
            jbackend.shards.store.read(jbackend.shards.cids[s], jg))
        assert tbackend.shards.store.getattrs(tbackend.shards.cids[s], tg) \
            == jbackend.shards.store.getattrs(jbackend.shards.cids[s], jg)


# -- coalescing --------------------------------------------------------------

@pytest.mark.parametrize("plugin", ["jerasure", "jax"])
def test_cross_pg_runs_coalesce_into_one_launch(sides, plugin):
    rng = np.random.default_rng(2)
    pa = rng.integers(0, 256, 1000, dtype=np.uint8)
    pb = rng.integers(0, 256, 777, dtype=np.uint8)
    out = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        a, b = side.backend(0, q, plugin), side.backend(1, q, plugin)
        acks = []
        with a.pipeline(), b.pipeline():
            side.submit(a, "oa", 0, pa, 1, acks, "a")
            side.submit(b, "ob", 0, pb, 1, acks, "b")
        assert sorted(acks) == ["a", "b"]
        st = q.status()
        assert st["pg_mix_avg"] == 2.0
        np.testing.assert_array_equal(a.read(side.oid("oa"), 0, 1000), pa)
        np.testing.assert_array_equal(b.read(side.oid("ob"), 0, 777), pb)
        out.append((_counters(q), a, b))
    assert out[1][0] == out[0][0]
    assert out[1][0]["launches"] == 1 and out[1][0]["cross_pg_launches"] == 1
    for name, j, t in (("oa", out[0][1], out[1][1]),
                       ("ob", out[0][2], out[1][2])):
        _shards_equal(sides[0], j, sides[1], t, name)


def test_cross_pg_fused_results_match_unbatched(sides):
    """The demuxed super-batch (parity on disk and cumulative HashInfo
    crcs) equals each PG launching alone and the JAX queue's, chained
    appends included."""
    rng = np.random.default_rng(3)
    chunks = [rng.integers(0, 256, 512, dtype=np.uint8) for _ in range(3)]
    results = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        batched = [side.backend(i, q, "jax") for i in range(2)]
        solo = [side.backend(10 + i, None, "jax") for i in range(2)]
        for group in (batched, solo):
            with group[0].pipeline(), group[1].pipeline():
                for v, payload in enumerate(chunks[:2]):
                    side.submit(group[0], "x", v * 512, payload, v + 1)
                side.submit(group[1], "y", 0, chunks[2], 1)
        for bq, bs_, name, ln in ((batched[0], solo[0], "x", 1024),
                                  (batched[1], solo[1], "y", 512)):
            np.testing.assert_array_equal(bq.read(side.oid(name), 0, ln),
                                          bs_.read(side.oid(name), 0, ln))
            hq = bq.shards.get_hinfo(0, side.oid(name))
            hs = bs_.shards.get_hinfo(0, side.oid(name))
            assert hq.cumulative_shard_hashes == hs.cumulative_shard_hashes
            assert hq.total_chunk_size == hs.total_chunk_size
        results.append((_counters(q), batched))
    assert results[1][0] == results[0][0]
    assert results[1][0]["launches"] >= 1
    for i, name in enumerate(("x", "y")):
        _shards_equal(sides[0], results[0][1][i], sides[1], results[1][1][i],
                      name)


def test_lone_pg_flush_on_idle_stays_synchronous(sides):
    p = (np.arange(512) % 256).astype(np.uint8)
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        be = side.backend(0, q, "jax")
        acks = []
        side.submit(be, "solo", 0, p, 1, acks, 1)
        assert acks == [1], "lone op did not complete synchronously"
        assert q.status()["launches"] == 1
        np.testing.assert_array_equal(be.read(side.oid("solo"), 0, 512), p)


def test_window_timer_launches_without_finalize(sides):
    """An open dispatch window and a 40 ms batching window: the queue's
    worker launches the pending batch in the background, and nothing
    completes until the dispatch window closes."""
    for side in sides:
        q = side.queue(window_us=40_000.0)
        be = side.backend(0, q, "jerasure")
        acks = []
        with be.pipeline():
            op = side.submit(be, "w", 0, np.ones(512, dtype=np.uint8), 1,
                             acks, 1)
            deadline = time.time() + 10.0
            while q.status()["launches"] < 1 and time.time() < deadline:
                time.sleep(0.005)
            assert q.status()["launches"] == 1
            assert acks == [] and op.state != "done"
        assert acks == [1]


def test_byte_cap_launches_immediately(sides):
    for side in sides:
        q = side.queue(window_us=WIN_NEVER, max_bytes=1)
        be = side.backend(0, q, "jerasure")
        with be.pipeline():
            side.submit(be, "c", 0, np.ones(512, dtype=np.uint8), 1)
            assert q.status()["launches"] == 1
            assert q.status()["last_launch"]["occupancy_pct"] >= 100.0


# -- failure containment -----------------------------------------------------

def _failing(base):
    class Failing(base):
        fail_on = None       # (oid name, shard)

        def sub_write(self, shard, txn, on_commit, **kw):
            if self.fail_on is not None and shard == self.fail_on[1] and \
                    any(self.fail_on[0] in str(g) for g in txn.ops):
                self.fail_on = None
                raise IOError("injected sub-write failure")
            return super().sub_write(shard, txn, on_commit, **kw)
    return Failing


def test_subwrite_failure_in_shared_batch_contained(sides):
    rng = np.random.default_rng(5)
    pa = rng.integers(0, 256, 512, dtype=np.uint8)
    pb = rng.integers(0, 256, 512, dtype=np.uint8)
    counters = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        a = side.backend(0, q, "jax",
                         shards_cls=_failing(side.be.LocalShardBackend))
        b = side.backend(1, q, "jax")
        a.shards.fail_on = ("fa", 5)
        with a.pipeline(), b.pipeline():
            opa = side.submit(a, "fa", 0, pa, 1)
            opb = side.submit(b, "fb", 0, pb, 1)
        assert opa.state == "failed" and opa.error is not None
        assert opb.state == "done" and opb.error is None
        np.testing.assert_array_equal(b.read(side.oid("fb"), 0, 512), pb)
        for be in (a, b):
            assert len(be.extent_cache) == 0 and not be._projected
        acks = []
        side.submit(a, "fa2", 0, pa, 2, acks, "a")
        side.submit(b, "fb2", 0, pb, 2, acks, "b")
        assert acks == ["a", "b"]
        counters.append(_counters(q))
    assert counters[1] == counters[0]


@pytest.mark.parametrize("plugin", ["jerasure", "jax"])
def test_poison_launch_fails_only_owner(sides, plugin):
    """A submission whose plugin dies at launch poisons the combined
    launch: the queue re-issues the same entry per submission, so only
    the owner's ticket fails (counted as one retry and one error) while
    the co-batched PG commits."""
    rng = np.random.default_rng(6)
    pa = rng.integers(0, 256, 512, dtype=np.uint8)
    pb = rng.integers(0, 256, 512, dtype=np.uint8)
    counters = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        a, b = side.backend(0, q, plugin), side.backend(1, q, plugin)

        def boom(*_a, **_k):
            raise RuntimeError("injected launch failure")
        # the entry the queue launches this plugin's appends through
        entry = "encode_chunks" if plugin == "jerasure" \
            else "encode_extents_with_crc_submit"
        setattr(a.ec_impl, entry, boom)
        with a.pipeline(), b.pipeline():        # A submits first: the
            opa = side.submit(a, "pa", 0, pa, 1)    # combined launch
            opb = side.submit(b, "pb", 0, pb, 1)    # rides A's plugin
        assert opa.state == "failed"
        assert isinstance(opa.error, side.lq.LaunchQueueError)
        assert opb.state == "done" and opb.error is None
        np.testing.assert_array_equal(b.read(side.oid("pb"), 0, 512), pb)
        assert len(a.extent_cache) == 0 and not a._projected
        assert not a._sim_chunk and not a._sim_refs
        counters.append(_counters(q))
    assert counters[1] == counters[0]
    assert counters[1]["launch_retries"] == 1
    assert counters[1]["launch_errors"] == 1


def test_finalize_failure_fails_batch_queue_survives(sides):
    rng = np.random.default_rng(7)
    pa = rng.integers(0, 256, 512, dtype=np.uint8)
    counters = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        a, b = side.backend(0, q, "jax"), side.backend(1, q, "jax")
        orig = a.ec_impl.encode_extents_with_crc_finalize
        armed = {"on": True}

        def failing(handle, orig=orig, armed=armed):
            if armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected finalize failure")
            return orig(handle)
        a.ec_impl.encode_extents_with_crc_finalize = failing
        with a.pipeline(), b.pipeline():
            opa = side.submit(a, "za", 0, pa, 1)
            opb = side.submit(b, "zb", 0, pa, 1)
        assert opa.state == "failed" and opb.state == "failed"
        for be in (a, b):
            assert len(be.extent_cache) == 0 and not be._projected
            assert not be._sim_chunk and not be._sim_refs
        acks = []
        side.submit(a, "za2", 0, pa, 2, acks, "a")
        side.submit(b, "zb2", 0, pa, 2, acks, "b")
        assert acks == ["a", "b"]
        np.testing.assert_array_equal(a.read(side.oid("za2"), 0, 512), pa)
        counters.append(_counters(q))
    assert counters[1] == counters[0]


def test_finalizer_steals_launch_past_blocked_worker(sides):
    """A bound ticket's result() does not wait behind another key's slow
    launch in the flushing thread: it steals its own batch's launch."""
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        slow, fast = side.codec("jerasure", 4, 2), side.codec("jerasure", 2, 1)
        entered, release, slow_done = (threading.Event() for _ in range(3))
        orig = slow.encode_chunks

        def blocking(chunks, orig=orig, entered=entered, release=release,
                     slow_done=slow_done):
            entered.set()
            release.wait(10)
            slow_done.set()
            return orig(chunks)
        slow.encode_chunks = blocking
        slow_in = np.ones((4, 256), dtype=np.uint8)
        t_slow = q.submit_chunks(slow, slow_in)
        big = (np.arange(2 * 256, dtype=np.uint32) % 251).astype(
            np.uint8).reshape(2, 256)
        t_fast = q.submit_chunks(fast, big)
        flusher = threading.Thread(target=q.flush, daemon=True)
        flusher.start()
        assert entered.wait(5)
        par = np.asarray(t_fast.result())
        assert not slow_done.is_set()
        np.testing.assert_array_equal(par, np.asarray(fast.encode_chunks(big)))
        release.set()
        flusher.join(10)
        assert not flusher.is_alive()
        np.testing.assert_array_equal(np.asarray(t_slow.result()),
                                      np.asarray(orig(slow_in)))
        assert q.status()["launches"] == 2


def test_cancel_withdraws_pending_submission(sides):
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        t = q.submit_chunks(side.codec("jerasure"),
                            np.ones((4, 256), dtype=np.uint8))
        assert q.status()["pending_submissions"] == 1
        t.cancel()
        assert q.status()["pending_submissions"] == 0
        with pytest.raises(side.lq.LaunchQueueError):
            t.result()
        assert q.status()["launches"] == 0


# -- observability -----------------------------------------------------------

def test_queue_counters_and_latency_histogram(sides):
    p = np.ones(512, dtype=np.uint8)
    counters = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER, max_bytes=1 << 20)
        a, b = side.backend(0, q), side.backend(1, q)
        with a.pipeline(), b.pipeline():
            for v in range(2):
                side.submit(a, f"s{v}", 0, p, v + 1)
            side.submit(b, "t", 0, p, 1)
        st = q.status()
        assert st["coalesced_runs"] >= 3 and st["avg_runs_per_launch"] > 1
        assert 0 < st["occupancy_pct_avg"] <= 100.0
        dump = q.perf.dump()
        assert dump["ec_host_launches"] == st["launches"]
        assert dump["ec_host_launch_runs"] == st["coalesced_runs"]
        lat = q.perf.dump_latencies()
        assert lat["lat_ec_batch_wait"]["count"] == st["submissions"]
        assert a.perf.dump()["ec_host_queue_drains"] >= 2
        assert b.perf.dump()["ec_host_queue_drains"] >= 1
        counters.append((_counters(q), a.perf.dump()["ec_host_queue_drains"],
                         b.perf.dump()["ec_host_queue_drains"]))
    assert counters[1] == counters[0]


def test_codec_signature_batches_only_provable_twins():
    """Equal signatures exactly where the reference's are equal: same
    plugin and generator matrix; instance identity for minimal-density
    techniques and for a matrix without the matrix_determines_encode
    declaration; never across plugin types."""
    reg = tec.ErasureCodePluginRegistry.instance()
    sig = tlq.codec_signature
    j1, j2 = (reg.factory("jerasure", {"k": "4", "m": "2"}) for _ in "ab")
    j3 = reg.factory("jerasure", {"k": "6", "m": "2"})
    assert sig(j1) == sig(j2) and sig(j1) != sig(j3)
    x1, x2 = (reg.factory("torch", {"k": "4", "m": "2", "device": "cpu"})
              for _ in "ab")
    x3 = reg.factory("torch", {"k": "4", "m": "2", "device": "cpu",
                               "technique": "reed_sol_van"})
    assert sig(x1) == sig(x2) and sig(x1) != sig(x3)
    assert sig(x1) != sig(j1)
    l1, l2 = (reg.factory("jerasure", {"k": "4", "m": "2",
                                       "technique": "liberation"})
              for _ in "ab")
    assert sig(l1) != sig(l2) and sig(l1) == sig(l1)
    s1, s2 = (reg.factory("shec", {"k": "4", "m": "3", "c": "2"})
              for _ in "ab")
    assert sig(s1) != sig(s2)

    class MatNoDecl:
        matrix = j1.matrix

        def get_data_chunk_count(self):
            return 4

        def get_coding_chunk_count(self):
            return 2
    assert sig(MatNoDecl()) != sig(MatNoDecl())
    # the JAX package draws the same lines
    jreg = jec.ErasureCodePluginRegistry.instance()
    jj1, jj2 = (jreg.factory("jerasure", {"k": "4", "m": "2"}) for _ in "ab")
    assert jlq.codec_signature(jj1) == jlq.codec_signature(jj2)
    assert tlq.matrix_signature(j1.matrix, 4, 2) == \
        jlq.matrix_signature(jj1.matrix, 4, 2)


# -- decode coalescing at a width that is not a power of two ---------------

def test_non_pow2_coalesced_decode_width(sides):
    """Three PGs' decodes of 1000 + 777 + 300 columns coalesce into one
    launch of their real width (the reference pads it to 2048); every
    demuxed result equals a private decode and the JAX queue's, and the
    flight recorder's bucket names the real width."""
    from ceph_tpu_torch.ops.profiler import device_profiler
    rng = np.random.default_rng(8)
    widths = (1000, 777, 300)
    datas = [rng.integers(0, 256, (4, w), dtype=np.uint8) for w in widths]
    got = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        tickets, fulls = [], []
        for owner, data in enumerate(datas):
            codec = side.codec("jax")
            full = np.concatenate([data, np.asarray(codec.encode_chunks(data))])
            dense = full.copy()
            dense[[0, 4]] = 0
            tickets.append(q.submit_decode(codec, dense, [4, 0], owner=owner))
            fulls.append(full)
        if side.port:
            device_profiler().reset()
        res = [np.asarray(t.result()) for t in tickets]
        for r, full in zip(res, fulls):
            np.testing.assert_array_equal(r, full)
        got.append((_counters(q), res))
    assert got[1][0] == got[0][0]
    assert got[1][0]["decode_launches"] == 1
    assert got[1][0]["cross_pg_launches"] == 1
    prof = device_profiler().profile()
    assert prof["by_kind"] == {"decode": 1}
    assert prof["recent"][-1]["bucket"] == f"d:e04:w{sum(widths)}"


def test_decode_cap_splits_launches_like_jax(sides):
    """Submissions of one key split at DECODE_MAX_LAUNCH_W (65536) of
    summed width, greedily in submission order: the same launches on
    both sides."""
    assert tlq.DECODE_MAX_LAUNCH_W == jlq.DECODE_MAX_LAUNCH_W == 65536
    widths = (40000, 20000, 10000, 70000, 1000)
    rng = np.random.default_rng(9)
    datas = [rng.integers(0, 256, (4, w), dtype=np.uint8) for w in widths]
    got = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER, max_bytes=1 << 30)
        codec = side.codec("jax")
        tickets = []
        for owner, data in enumerate(datas):
            dense = np.concatenate([data, np.asarray(codec.encode_chunks(data))])
            dense[2] = 0
            tickets.append((q.submit_decode(codec, dense, [2], owner=owner),
                            data[2]))
        for t, want in tickets:
            np.testing.assert_array_equal(np.asarray(t.result())[2], want)
        got.append(_counters(q))
    assert got[1] == got[0]
    assert got[1]["decode_launches"] == 4    # 40000+20000 | 10000 | 70000 | 1000


def test_mixed_width_super_batch_splits_and_demuxes(sides):
    """A cross-PG super-batch mixing a hier-eligible run (a 512 KiB
    object at k=4: 128 KiB a shard) with a small one launches the split
    path (hier + flat) and demuxes back bit-exact: the same shards and
    HashInfo as the JAX queue's."""
    rng = np.random.default_rng(21)
    big = rng.integers(0, 256, 4 * 128 * 1024, dtype=np.uint8)
    small = rng.integers(0, 256, 600, dtype=np.uint8)
    out = []
    for side in sides:
        q = side.queue(window_us=WIN_NEVER)
        a = side.backend(0, q, "jax", chunk=4096)
        b = side.backend(1, q, "jax", chunk=4096)
        if side.port:
            from ceph_tpu_torch.ops import autotune
            for be in (a, b):
                be.ec_impl._fused_point = dict(autotune.default_point(),
                                               combine="kernel")
        with a.pipeline(), b.pipeline():
            side.submit(a, "big", 0, big, 1)
            side.submit(b, "small", 0, small, 1)
        out.append((_counters(q), a, b))
        np.testing.assert_array_equal(a.read(side.oid("big")), big)
        np.testing.assert_array_equal(b.read(side.oid("small")), small)
    assert out[1][0] == out[0][0] and out[1][0]["launches"] == 1
    assert out[1][1].fused_path == "hier_acc+w32_flat"
    _shards_equal(sides[0], out[0][1], sides[1], out[1][1], "big")
    _shards_equal(sides[0], out[0][2], sides[1], out[1][2], "small")


# -- the port's own rules ------------------------------------------------------

def test_queue_refuses_a_plugin_on_another_device():
    q = tlq.ECLaunchQueue(window_us=WIN_NEVER, device="cpu")
    try:
        codec = tec.ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": "4", "m": "2", "device": "cpu"})
        codec.device = torch.device("meta")      # stands in for a card
        with pytest.raises(ValueError, match="launch queue on cpu"):
            q.submit_chunks(codec, np.ones((4, 64), dtype=np.uint8))
        assert q.status()["pending_submissions"] == 0
    finally:
        q.close()


def test_cuda_queue_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlq.ECLaunchQueue()                       # default device: cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlq.ECLaunchQueue.host_instance(device="cuda")
    assert tlq.ECLaunchQueue.host_get() is None


def test_host_instance_and_reset_close_the_worker():
    tlq.ECLaunchQueue.reset_host()
    q = tlq.ECLaunchQueue.host_instance(window_us=1000.0, device="cpu")
    try:
        assert tlq.ECLaunchQueue.host_instance() is q
        codec = tec.ErasureCodePluginRegistry.instance().factory(
            "jerasure", {"k": "4", "m": "2"})
        t = q.submit_chunks(codec, np.ones((4, 64), dtype=np.uint8))
        worker = q._worker
        assert worker is not None and worker.is_alive()
        np.testing.assert_array_equal(
            t.result(), codec.encode_chunks(np.ones((4, 64), dtype=np.uint8)))
    finally:
        tlq.ECLaunchQueue.reset_host()
    assert tlq.ECLaunchQueue.host_get() is None
    assert not worker.is_alive()


def test_stress_many_threads_one_queue():
    """Eight threads submit decodes and plain encodes through one queue
    with a 1 ms window and a short switch interval: every ticket's
    result equals its private launch, and every submission launched
    exactly once."""
    import sys
    reg = tec.ErasureCodePluginRegistry.instance()
    q = tlq.ECLaunchQueue(window_us=1000.0, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors = []

    def worker(seed):
        try:
            rng = np.random.default_rng(seed)
            codec = reg.factory("torch", {"k": "4", "m": "2",
                                          "device": "cpu"})
            for i in range(6):
                data = rng.integers(0, 256, (4, 64 + seed + i),
                                    dtype=np.uint8)
                par = codec.encode_chunks(data)
                t = q.submit_chunks(codec, data, owner=seed)
                full = np.concatenate([data, par])
                dense = full.copy()
                dense[1] = 0
                d = q.submit_decode(codec, dense, [1], owner=seed)
                np.testing.assert_array_equal(t.result(), par)
                np.testing.assert_array_equal(d.result(), full)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        q.close()
    assert not errors, errors[0]
    st = q.status()
    assert st["submissions"] == 8 * 6 * 2
    assert st["pending_submissions"] == 0


def test_flight_recorder_records_direct_and_queued_launches():
    """The backend's direct launches and the queue's launches land in
    the flight recorder by kind; on the CPU no kernel library is built,
    so every first-seen bucket is a cache hit and nothing compiled."""
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops.profiler import device_profiler
    prof = device_profiler()
    prof.reset()
    port = Side(True)
    try:
        p = np.ones(4 * 64 * 2, dtype=np.uint8)
        direct = port.backend(0, None, "jax")
        port.submit(direct, "d", 0, p, 1)
        port.submit(direct, "d", 100, p[:10], 2)        # overwrite: plain
        q = port.queue(window_us=WIN_NEVER)
        queued = port.backend(1, q, "jax")
        port.submit(queued, "q", 0, p, 1)
        host = port.backend(2, None, "jerasure")
        port.submit(host, "h", 0, p, 1)
    finally:
        port.close()
    got = prof.profile()
    assert got["by_kind"] == {"fused_encode": 2, "plain_encode": 2}
    ledger = prof.compile_ledger()
    assert ledger["kernel_library"] == _build.status()
    assert ledger["compile_stalls"] == 0 and ledger["total_compile_s"] == 0
    assert all(r["cache_hit"] for r in ledger["buckets"])
    # the host plugin's encode has no kernel behind it: no bucket
    assert not any(r["bucket"].startswith("c:np") for r in ledger["buckets"])

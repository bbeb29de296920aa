"""The port's op scheduler (ceph_tpu_torch/osd/scheduler.py): the unit
tests of tests/test_scheduler.py (all but its cluster tests, and
test_config_rejects_unknown_profile_name, which waits for
common/options) and the scheduler tests of tests/test_scrub_recovery.py,
run on the port and on the JAX package's module.  Where the reference
passes a `Config`, these pass a plain dict with the same keys.  A last
test drives both modules through the same seeded workload and requires
the same dequeue order, phases and stats."""

import threading
import time

import numpy as np
import pytest

import ceph_tpu.osd.scheduler as jsched
import ceph_tpu_torch.osd.scheduler as tsched
from ceph_tpu.common import perf_counters as jperf
from ceph_tpu_torch.common import perf_counters as tperf


class _Side:
    def __init__(self, mod, perf):
        for name in ("MCLOCK_PROFILES", "ClientProfile", "MClockScheduler",
                     "ShardedOpWQ", "make_scheduler",
                     "parse_custom_profile", "profiles_from_conf",
                     "WeightedPriorityQueue"):
            setattr(self, name, getattr(mod, name))
        self.PerfCountersBuilder = perf.PerfCountersBuilder


@pytest.fixture(params=["port", "reference"])
def side(request):
    if request.param == "port":
        return _Side(tsched, tperf)
    return _Side(jsched, jperf)


def _conf():
    """The two options the scheduler reads, at their defaults."""
    return {"osd_mclock_profile": "balanced",
            "osd_mclock_custom_profile": ""}


# -- dequeue phases ----------------------------------------------------------

def test_reservation_phase_served_first(side):
    """A class behind its reservation tag beats any proportional
    contender, regardless of weight."""
    s = side.MClockScheduler({
        "reserved": side.ClientProfile(reservation=10.0, weight=0.1),
        "heavy": side.ClientProfile(reservation=0.0, weight=100.0)})
    s.enqueue("h", "heavy", now=0.0)
    s.enqueue("r", "reserved", now=0.0)
    assert s.dequeue(now=0.0) == "r"
    assert s.last_phase == "reservation"
    assert s.stats["reserved"]["reservation_served"] == 1


def test_proportional_phase_weighted_shares(side):
    """With no reservations, service divides by weight (WFQ tags):
    weight 3 : 1 -> ~3x the serves over a long drain."""
    s = side.MClockScheduler({
        "big": side.ClientProfile(weight=3.0),
        "small": side.ClientProfile(weight=1.0)})
    for i in range(200):
        s.enqueue(("big", i), "big", now=0.0)
        s.enqueue(("small", i), "small", now=0.0)
    first100 = [s.dequeue(now=0.0)[0] for _ in range(100)]
    assert s.last_phase == "proportional"
    big = first100.count("big")
    assert 65 <= big <= 85, f"weighted share off: {big}/100"


def test_proportional_phase_respects_limit(side):
    """A limit-capped class is skipped in the proportional phase while
    an uncapped class has work."""
    s = side.MClockScheduler({
        "capped": side.ClientProfile(weight=10.0, limit=1.0),
        "free": side.ClientProfile(weight=1.0)})
    for i in range(3):
        s.enqueue(("capped", i), "capped", now=0.0)
        s.enqueue(("free", i), "free", now=0.0)
    # first serve may take capped (l_tag 0 <= now); afterwards its
    # l_tag sits 1s ahead — every following dequeue at now~0 must
    # serve the free class
    got = [s.dequeue(now=0.001 * (i + 1))[0] for i in range(4)]
    assert got.count("capped") <= 1
    assert got.count("free") == 3


def test_work_conserving_fallback(side):
    """All backlogged classes over their limit and none reservation-
    eligible: dequeue still serves (limits only bind under
    contention, as in dmclock) and records the fallback phase."""
    s = side.MClockScheduler(
        {"only": side.ClientProfile(weight=1.0, limit=2.0)})
    s.enqueue("a", "only", now=0.0)
    s.enqueue("b", "only", now=0.0)
    assert s.dequeue(now=0.0) == "a"          # l_tag -> 0.5
    assert s.last_phase == "proportional"
    assert s.dequeue(now=0.01) == "b"         # capped, served anyway
    assert s.last_phase == "fallback"
    assert s.stats["only"]["fallback_served"] == 1


def test_empty_dequeue_returns_none(side):
    s = side.MClockScheduler()
    assert s.dequeue(now=0.0) is None
    assert s.empty()
    assert len(s) == 0


# -- tag advancement math ----------------------------------------------------

def test_reservation_tag_advances_by_inverse_rate(side):
    s = side.MClockScheduler({"c": side.ClientProfile(reservation=10.0,
                                            weight=1.0, limit=5.0)})
    for i in range(3):
        s.enqueue(i, "c", now=100.0)
    assert s.dequeue(now=100.0) == 0
    # r advanced from max(0, now)=100 by 1/10; l by 1/5
    assert s._r_tags["c"] == pytest.approx(100.1)
    assert s._l_tags["c"] == pytest.approx(100.2)
    # between the tags: not reservation-eligible yet (r 100.1) and
    # limit-capped (l 100.2) — only the fallback phase can serve
    assert s.dequeue(now=100.05) == 1
    assert s.last_phase == "fallback"
    # at/past the reservation tag the reservation phase resumes;
    # the tag re-advances from now (eligibility implies now >= tag)
    assert s.dequeue(now=100.12) == 2
    assert s.last_phase == "reservation"
    assert s._r_tags["c"] == pytest.approx(100.22)


def test_proportional_tag_is_wfq_virtual_time(side):
    s = side.MClockScheduler({"w2": side.ClientProfile(weight=2.0),
                         "w1": side.ClientProfile(weight=1.0)})
    s.enqueue("a", "w2", now=0.0)
    s.enqueue("b", "w2", now=0.0)
    s.enqueue("c", "w1", now=0.0)
    assert s.dequeue(now=0.0) == "a"          # w2: p 0 -> 0.5
    assert s._p_tags["w2"] == pytest.approx(0.5)
    assert s.dequeue(now=0.0) == "c"          # w1: p 0 -> 1.0
    assert s._p_tags["w1"] == pytest.approx(1.0)
    assert s.dequeue(now=0.0) == "b"          # w2: 0.5 -> 1.0
    assert s._p_tags["w2"] == pytest.approx(1.0)


def test_idle_class_anchors_at_current_vtime(side):
    """A class joining mid-run must not bank credit from the epoch:
    its first proportional tag starts at the current virtual time."""
    s = side.MClockScheduler({"a": side.ClientProfile(weight=1.0)})
    for i in range(10):
        s.enqueue(i, "a", now=0.0)
    for _ in range(10):
        s.dequeue(now=0.0)
    assert s._vtime > 0
    s.enqueue("late", "b", now=0.0)     # dynamic class, default triple
    assert s._p_tags["b"] == pytest.approx(s._vtime)


# -- profiles from config ----------------------------------------------------

def test_parse_custom_profile(side):
    p = side.parse_custom_profile("a:1,2,3; b:4.5,6,0")
    assert p["a"] == side.ClientProfile(1.0, 2.0, 3.0)
    assert p["b"] == side.ClientProfile(4.5, 6.0, 0.0)
    assert side.parse_custom_profile("") == {}
    with pytest.raises(ValueError):
        side.parse_custom_profile("a:1,2")          # triple required
    with pytest.raises(ValueError):
        side.parse_custom_profile("a:1,0,3")        # weight must be > 0
    with pytest.raises(ValueError):
        side.parse_custom_profile("a:-1,2,3")       # negative rate
    with pytest.raises(ValueError):
        side.parse_custom_profile("a:nan,1,0")      # NaN poisons tag math
    with pytest.raises(ValueError):
        side.parse_custom_profile("a:1,inf,0")
    with pytest.raises(ValueError):
        side.parse_custom_profile("a:100,1,50")     # cap below guarantee
    side.parse_custom_profile("a:100,1,100")        # cap == guarantee: ok


def test_profiles_from_conf_named_and_custom(side):
    conf = _conf()
    base = side.profiles_from_conf(conf)
    assert base["client"] == side.MCLOCK_PROFILES["balanced"]["client"]
    conf["osd_mclock_profile"] = "high_client_ops"
    p = side.profiles_from_conf(conf)
    assert p["client"].reservation == 200.0
    assert p["recovery"].limit == 100.0
    # custom entries override per class AND add tenant classes
    conf["osd_mclock_custom_profile"] = "client:42,1,0;tenant_a:10,2,50"
    p = side.profiles_from_conf(conf)
    assert p["client"].reservation == 42.0
    assert p["tenant_a"] == side.ClientProfile(10.0, 2.0, 50.0)
    assert p["scrub"] == side.MCLOCK_PROFILES["high_client_ops"]["scrub"]


def test_set_profiles_runtime_swap(side):
    s = side.MClockScheduler()
    s.enqueue("x", "tenant_z", now=0.0)     # dynamic class, default
    assert s.profiles["tenant_z"] == side.ClientProfile()
    s.set_profiles({"tenant_z": side.ClientProfile(5.0, 2.0, 0.0),
                    "client": side.ClientProfile(1.0, 1.0, 0.0)})
    assert s.profiles["tenant_z"].reservation == 5.0
    assert s.profiles["client"].reservation == 1.0
    # queued item survives the swap
    assert s.dequeue(now=0.0) == "x"


def test_make_scheduler_kinds(side):
    assert isinstance(side.make_scheduler("wpq"), side.WeightedPriorityQueue)
    conf = _conf()
    conf["osd_mclock_profile"] = "high_recovery_ops"
    s = side.make_scheduler("mclock", conf=conf)
    assert isinstance(s, side.MClockScheduler)
    assert s.profiles["recovery"].reservation == 50.0


# -- observability counters --------------------------------------------------

def test_per_class_stats_and_perf_counters(side):
    perf = side.PerfCountersBuilder("mclock.test").create_perf_counters()
    s = side.MClockScheduler({"client": side.ClientProfile(reservation=10.0),
                         "scrub": side.ClientProfile(weight=0.5)},
                        perf=perf)
    s.enqueue("a", "client", now=0.0)
    s.enqueue("b", "scrub", now=0.0)
    s.dequeue(now=0.25)                       # client, reservation
    s.dequeue(now=0.5)                        # scrub, proportional
    assert s.stats["client"]["queued"] == 1
    assert s.stats["client"]["dequeued"] == 1
    assert s.stats["client"]["wait_sum"] == pytest.approx(0.25)
    assert s.stats["scrub"]["wait_max"] == pytest.approx(0.5)
    dump = perf.dump()
    assert dump["mclock_queued_client"] == 1
    assert dump["mclock_reservation_served_client"] == 1
    assert dump["mclock_proportional_served_scrub"] == 1
    # queue-wait histograms feed the percentile pipeline
    lat = perf.dump_latencies()
    assert lat["lat_qwait_client"]["count"] == 1
    assert lat["lat_qwait_scrub"]["p99"] is not None
    # and the dump() payload names phases + profiles per class
    d = s.dump()
    assert d["classes"]["client"]["profile"]["reservation"] == 10.0
    assert d["classes"]["scrub"]["proportional_served"] == 1


def test_sharded_wq_mclock_executes_and_dumps(side):
    conf = _conf()
    wq = side.ShardedOpWQ(n_threads=2, kind="mclock", conf=conf)
    try:
        done = []
        ev = threading.Event()
        for i in range(10):
            wq.queue(lambda i=i: (done.append(i),
                                  ev.set() if len(done) == 10
                                  else None),
                     op_class="client" if i % 2 else "recovery")
        assert ev.wait(5)
        d = wq.dump()
        total = sum(c["dequeued"] for c in d["classes"].values())
        assert total == 10
        # runtime re-resolve keeps queues intact
        conf["osd_mclock_profile"] = "high_client_ops"
        wq.apply_conf(conf)
        assert wq.scheduler.profiles["client"].reservation == 200.0
    finally:
        wq.drain_and_stop()
    assert sorted(done) == list(range(10))


def test_drain_and_stop_drains_fast_backlog(side):
    """Queued ops were accepted: a shutdown with a quick backlog runs
    them all instead of stranding their clients."""
    wq = side.ShardedOpWQ(n_threads=2, kind="mclock", conf=_conf())
    ran = []
    for i in range(100):
        wq.queue(lambda i=i: ran.append(i))
    wq.drain_and_stop()
    assert len(ran) == 100


def test_drain_and_stop_abort_bounds_teardown(side):
    """...but the drain is BOUNDED: past the grace, workers abort so a
    killed daemon can't keep applying ops into a store a revived
    daemon has re-mounted."""
    wq = side.ShardedOpWQ(n_threads=1, kind="mclock", conf=_conf())
    ran = []
    for i in range(200):
        wq.queue(lambda i=i: (ran.append(i), time.sleep(0.05)))
    t0 = time.time()
    wq.drain_and_stop(grace=0.4)
    assert time.time() - t0 < 3.0
    assert 0 < len(ran) < 200


# -- the schedulers of tests/test_scrub_recovery.py -------------------------

def test_wpq_strict_first(side):
    q = side.WeightedPriorityQueue()
    q.enqueue("low", priority=1)
    q.enqueue("urgent", priority=255, strict=True)
    q.enqueue("mid", priority=64)
    assert q.dequeue() == "urgent"
    assert len(q) == 2


def test_wpq_weighted_share(side):
    q = side.WeightedPriorityQueue()
    for i in range(30):
        q.enqueue(("hi", i), priority=90)
        q.enqueue(("lo", i), priority=10)
    first20 = [q.dequeue()[0] for _ in range(20)]
    assert first20.count("hi") > first20.count("lo")


def test_mclock_reservation_and_classes(side):
    s = side.MClockScheduler()
    for i in range(5):
        s.enqueue(("client", i), "client")
        s.enqueue(("recovery", i), "recovery")
    got = []
    while not s.empty():
        got.append(s.dequeue()[0])
    assert got.count("client") == 5 and got.count("recovery") == 5
    # client's higher reservation should front-load its ops
    assert got[:3].count("client") >= 2


def test_sharded_op_wq_executes(side):
    wq = side.ShardedOpWQ(n_threads=2)
    done = []
    import threading
    ev = threading.Event()
    for i in range(10):
        wq.queue(lambda i=i: (done.append(i),
                              ev.set() if len(done) == 10 else None))
    assert ev.wait(5)
    wq.drain_and_stop()
    assert sorted(done) == list(range(10))


def _trace(mod, seed):
    rng = np.random.default_rng(seed)
    s = mod.MClockScheduler({
        "client": mod.ClientProfile(reservation=20.0, weight=2.0),
        "recovery": mod.ClientProfile(reservation=5.0, weight=1.0,
                                      limit=40.0),
        "scrub": mod.ClientProfile(weight=0.5, limit=10.0)})
    now = 0.0
    out = []
    for i in range(400):
        now += float(rng.exponential(0.004))
        if rng.random() < 0.6:
            cls = ("client", "recovery", "scrub", "tenant")[
                int(rng.integers(0, 4))]
            s.enqueue((cls, i), cls, now=now)
        else:
            got = s.dequeue(now=now)
            out.append((got, s.last_phase if got is not None else None))
    while not s.empty():
        now += 0.001
        out.append((s.dequeue(now=now), s.last_phase))
    return out, s.dump()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_workload_same_service_as_reference(seed):
    assert _trace(tsched, seed) == _trace(jsched, seed)

"""Op scheduler: QoS between client / recovery / scrub / tenant work.

Re-expresses reference src/osd/scheduler/ (OpScheduler.cc:24
make_scheduler): a pluggable queue the OSD's worker shards pull from,
either weighted-priority (WPQ) or an mClock-style
reservation/weight/limit dequeuer (src/osd/scheduler/mClockScheduler.h,
src/dmclock submodule).  The mClock here implements the core dmclock
idea — per-class virtual tags from (reservation, weight, limit) — not
the full distributed protocol.

Observability (docs/QOS.md): every enqueue/dequeue, the phase that
served it (reservation / weighted proportional / work-conserving
fallback) and the per-class queue wait are counted — into the
scheduler's own `stats` dict always, and into a PerfCounters set
(`mclock_*` u64s + `lat_qwait_<class>` histograms) when one is wired,
so `perf dump` / `dump_latencies` / the prometheus exporter can answer
"who waited, and which phase served whom" without touching the
scheduler.  The dequeue clock is injectable (`now=`) so tag math is
unit-testable and the load harness can drive it in virtual time.
"""

from __future__ import annotations

import heapq
import itertools
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(order=True)
class _WPQItem:
    sort_key: tuple
    item: Any = field(compare=False)


class WeightedPriorityQueue:
    """Strict-then-weighted priorities (reference WeightedPriorityQueue):
    strict items first; others dequeued proportionally to priority."""

    def __init__(self):
        self._strict: list = []
        self._heap: list[_WPQItem] = []
        self._counter = itertools.count()
        self._vclock = 0.0

    def enqueue(self, item, priority: int = 63, strict: bool = False,
                **_):
        if strict:
            self._strict.append((priority, next(self._counter), item))
            self._strict.sort(key=lambda t: (-t[0], t[1]))
        else:
            # virtual finish time ~ 1/priority spacing
            self._vclock += 1.0
            key = (self._vclock / max(priority, 1), next(self._counter))
            heapq.heappush(self._heap, _WPQItem(key, item))

    def dequeue(self, now: float | None = None):
        if self._strict:
            return self._strict.pop(0)[2]
        if self._heap:
            return heapq.heappop(self._heap).item
        return None

    def empty(self) -> bool:
        return not self._strict and not self._heap

    def __len__(self):
        return len(self._strict) + len(self._heap)


@dataclass
class ClientProfile:
    """dmclock (reservation, weight, limit) triple per op class."""
    reservation: float = 0.0   # ops/sec guaranteed
    weight: float = 1.0        # proportional share
    limit: float = 0.0         # ops/sec cap (0 = none)


# Named presets (reference osd_mclock_profile: the shipped profiles
# trade client latency against background-work progress; docs/QOS.md).
MCLOCK_PROFILES: dict[str, dict[str, ClientProfile]] = {
    "balanced": {
        "client": ClientProfile(reservation=100.0, weight=2.0),
        "recovery": ClientProfile(reservation=10.0, weight=1.0,
                                  limit=500.0),
        "scrub": ClientProfile(reservation=5.0, weight=0.5, limit=200.0),
    },
    "high_client_ops": {
        "client": ClientProfile(reservation=200.0, weight=4.0),
        "recovery": ClientProfile(reservation=5.0, weight=1.0,
                                  limit=100.0),
        "scrub": ClientProfile(reservation=2.0, weight=0.5, limit=50.0),
    },
    "high_recovery_ops": {
        "client": ClientProfile(reservation=50.0, weight=2.0),
        "recovery": ClientProfile(reservation=50.0, weight=2.0),
        "scrub": ClientProfile(reservation=5.0, weight=1.0, limit=200.0),
    },
}


def parse_custom_profile(spec: str) -> dict[str, ClientProfile]:
    """'class:res,wgt,lim;...' -> {class: ClientProfile}.  The runtime
    override format of osd_mclock_custom_profile — also how tenant
    classes (which the schema can't predeclare) get their triples."""
    out: dict[str, ClientProfile] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        cls, _, triple = entry.partition(":")
        cls = cls.strip()
        parts = [p.strip() for p in triple.split(",")]
        if not cls or len(parts) != 3:
            raise ValueError(
                f"bad mclock profile entry {entry!r} "
                f"(want 'class:res,wgt,lim')")
        res, wgt, lim = (float(p) for p in parts)
        # NaN slips past every <=/< guard and then poisons the tag
        # comparisons (a NaN-weighted class silently starves)
        if not all(math.isfinite(x) for x in (res, wgt, lim)):
            raise ValueError(f"non-finite rate in {entry!r}")
        if wgt <= 0:
            raise ValueError(f"mclock weight must be > 0 in {entry!r}")
        if res < 0 or lim < 0:
            raise ValueError(f"negative rate in {entry!r}")
        if 0 < lim < res:
            # the reservation phase ignores limit tags, so a cap
            # below the guarantee would silently never bind (the
            # reference dmclock rejects limit < reservation too)
            raise ValueError(
                f"limit {lim} < reservation {res} in {entry!r}")
        out[cls] = ClientProfile(res, wgt, lim)
    return out


def profiles_from_conf(conf) -> dict[str, ClientProfile]:
    """Resolve the effective per-class profiles from config:
    osd_mclock_profile names the preset ('custom' starts from
    'balanced'), osd_mclock_custom_profile overrides per class on
    top (reference: mclock profile options expand the same way)."""
    name = str(conf.get("osd_mclock_profile"))
    base = MCLOCK_PROFILES.get(name, MCLOCK_PROFILES["balanced"])
    profiles = {c: ClientProfile(p.reservation, p.weight, p.limit)
                for c, p in base.items()}
    spec = str(conf.get("osd_mclock_custom_profile"))
    if spec:
        profiles.update(parse_custom_profile(spec))
    return profiles


# internal background classes: never accepted from the wire — a client
# declaring qos="recovery" would ride (and distort the accounting of)
# the background class's reservation/limit instead of its own
WIRE_BLOCKED_CLASSES = frozenset({"recovery", "scrub"})


def _zero_stats() -> dict:
    return {"queued": 0, "dequeued": 0, "reservation_served": 0,
            "proportional_served": 0, "fallback_served": 0,
            "wait_sum": 0.0, "wait_max": 0.0}


class MClockScheduler:
    """Single-node dmclock: tag ops with reservation/proportional virtual
    times, serve reservation-eligible first, then by weight, respecting
    limits (reference mClockScheduler defaults: client/recovery/scrub
    classes).

    Tag math per class c with profile (res, wgt, lim):
      reservation tag  r[c]: serve when r[c] <= now, then
                       r[c] = max(r[c], now) + 1/res   (wall clock)
      limit tag        l[c]: proportional phase skips while l[c] > now;
                       l[c] = max(l[c], now) + 1/lim on EVERY serve
      proportional tag p[c]: WFQ virtual time — smallest p wins, then
                       p[c] = max(p[c], vtime) + 1/wgt; a class that
                       wakes from idle is anchored at the current
                       vtime (no banked credit, no stale penalty)
    Limits only bind under contention: when nothing is reservation-
    eligible and every backlogged class is limit-capped, the fallback
    phase serves the lowest proportional tag anyway (work conserving,
    as in dmclock).
    """

    DEFAULT_PROFILES = MCLOCK_PROFILES["balanced"]

    def __init__(self, profiles: dict[str, ClientProfile] | None = None,
                 perf=None):
        self.profiles = {
            c: ClientProfile(p.reservation, p.weight, p.limit)
            for c, p in (profiles or self.DEFAULT_PROFILES).items()}
        self.perf = perf
        self._queues: dict[str, list] = {}
        self._r_tags: dict[str, float] = {}
        self._l_tags: dict[str, float] = {}
        self._p_tags: dict[str, float] = {}
        self._vtime = 0.0
        self._counter = itertools.count()
        self.stats: dict[str, dict] = {}
        self.last_phase: str | None = None
        for c in self.profiles:
            self._ensure_class(c)

    # -- class/profile management -------------------------------------------

    def _ensure_class(self, op_class: str) -> None:
        if op_class in self._queues:
            return
        self._queues[op_class] = []
        self.profiles.setdefault(op_class, ClientProfile())
        self._r_tags[op_class] = 0.0
        self._l_tags[op_class] = 0.0
        # anchor at the current virtual time: a class born mid-run
        # competes from here, not from the epoch
        self._p_tags[op_class] = self._vtime
        self.stats[op_class] = _zero_stats()

    def set_profile(self, op_class: str, profile: ClientProfile) -> None:
        """Runtime (reservation, weight, limit) update for one class."""
        self._ensure_class(op_class)
        self.profiles[op_class] = profile

    def set_profiles(self, profiles: dict[str, ClientProfile]) -> None:
        """Runtime profile swap (mon `osd mclock profile set` landing
        via the config observer).  Queued items stay queued; classes
        the new profile set doesn't name keep running on the default
        best-effort triple."""
        for c, p in profiles.items():
            self.set_profile(c, p)
        for c in self._queues:
            if c not in profiles:
                self.profiles[c] = ClientProfile()

    def apply_conf(self, conf) -> None:
        self.set_profiles(profiles_from_conf(conf))

    # -- queue ops ----------------------------------------------------------

    def enqueue(self, item, op_class: str = "client",
                now: float | None = None, **_):
        now = time.monotonic() if now is None else now
        self._ensure_class(op_class)
        self._queues[op_class].append((next(self._counter), now, item))
        self.stats[op_class]["queued"] += 1
        if self.perf is not None:
            self.perf.dinc(f"mclock_queued_{op_class}")

    def _pick(self, now: float) -> tuple[str | None, str]:
        # 1: reservation phase — any class behind its reservation tag
        best = None
        for c, q in self._queues.items():
            if not q:
                continue
            if self.profiles[c].reservation > 0 and \
                    self._r_tags[c] <= now:
                if best is None or self._r_tags[c] < self._r_tags[best]:
                    best = c
        if best is not None:
            return best, "reservation"
        # 2: proportional phase by weight tags (limit-respecting)
        for c, q in self._queues.items():
            if not q:
                continue
            if self.profiles[c].limit > 0 and self._l_tags[c] > now:
                continue
            if best is None or self._p_tags[c] < self._p_tags[best]:
                best = c
        if best is not None:
            return best, "proportional"
        # 3: work-conserving fallback — nothing reservation-eligible
        # and every backlogged class is ahead of its cap; serve the
        # lowest proportional tag anyway (limits only bind under
        # contention, as in dmclock)
        for c, q in self._queues.items():
            if not q:
                continue
            if best is None or self._p_tags[c] < self._p_tags[best]:
                best = c
        return best, "fallback"

    def dequeue(self, now: float | None = None):
        now = time.monotonic() if now is None else now
        best, phase = self._pick(now)
        if best is None:
            return None
        prof = self.profiles[best]
        if phase == "reservation":
            self._r_tags[best] = max(self._r_tags[best], now) + \
                1.0 / prof.reservation
        else:
            start = max(self._p_tags[best], self._vtime)
            self._vtime = start
            self._p_tags[best] = start + 1.0 / max(prof.weight, 1e-9)
        if prof.limit > 0:
            self._l_tags[best] = max(self._l_tags[best], now) + \
                1.0 / prof.limit
        _seq, enq_ts, item = self._queues[best].pop(0)
        wait = max(0.0, now - enq_ts)
        st = self.stats[best]
        st["dequeued"] += 1
        st[f"{phase}_served"] += 1
        st["wait_sum"] += wait
        st["wait_max"] = max(st["wait_max"], wait)
        self.last_phase = phase
        if self.perf is not None:
            self.perf.dinc(f"mclock_dequeued_{best}")
            self.perf.dinc(f"mclock_{phase}_served_{best}")
            self.perf.hinc(f"lat_qwait_{best}", wait)
        return item

    # -- introspection -------------------------------------------------------

    def dump(self) -> dict:
        """Per-class QoS state for the `dump_mclock` asok command:
        profile triples, queue depths, phase serve counts, waits."""
        return {
            "vtime": self._vtime,
            "classes": {
                c: {
                    "profile": {
                        "reservation": self.profiles[c].reservation,
                        "weight": self.profiles[c].weight,
                        "limit": self.profiles[c].limit,
                    },
                    "queue_len": len(self._queues[c]),
                    **self.stats[c],
                }
                for c in self._queues},
        }

    def empty(self) -> bool:
        return all(not q for q in self._queues.values())

    def __len__(self):
        return sum(len(q) for q in self._queues.values())


def make_scheduler(kind: str, conf=None, perf=None):
    """reference OpScheduler.cc:24 make_scheduler."""
    if kind == "mclock":
        profiles = profiles_from_conf(conf) if conf is not None else None
        return MClockScheduler(profiles, perf=perf)
    return WeightedPriorityQueue()


class ShardedOpWQ:
    """N worker threads draining a scheduler (reference OSD.h:1568
    ShardedOpWQ: the thread pool between dispatch and PG work).  Items
    are thunks; op classes map to scheduler classes."""

    def __init__(self, n_threads: int = 2, kind: str = "wpq",
                 conf=None, perf=None):
        self.scheduler = make_scheduler(kind, conf=conf, perf=perf)
        self._cv = threading.Condition()
        self._stop = False
        self._abort = False
        self.threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"osd-op-wq-{i}")
            for i in range(n_threads)]
        for t in self.threads:
            t.start()

    def apply_conf(self, conf) -> None:
        """Re-resolve mclock profiles after a runtime config change
        (the OSD's osd_mclock_* observers land here)."""
        with self._cv:
            if isinstance(self.scheduler, MClockScheduler):
                self.scheduler.apply_conf(conf)

    def wire_class_ok(self, op_class: str) -> bool:
        """True when a client-declared QoS class may be honored: it
        must be operator-provisioned (a profile triple exists — the
        OSD collapses UNDECLARED wire strings into "client", since
        per-class queues/tags/counters live for the daemon's lifetime
        and arbitrary strings would mint unbounded scheduler state
        and metric cardinality) and must not name an internal
        background class (WIRE_BLOCKED_CLASSES)."""
        if op_class in WIRE_BLOCKED_CLASSES:
            return False
        with self._cv:
            return isinstance(self.scheduler, MClockScheduler) and \
                op_class in self.scheduler.profiles

    def dump(self) -> dict:
        with self._cv:
            if isinstance(self.scheduler, MClockScheduler):
                return self.scheduler.dump()
            return {"kind": "wpq", "queue_len": len(self.scheduler)}

    def queue(self, fn: Callable[[], None], op_class: str = "client",
              priority: int = 63, top=None) -> None:
        """top: optional TrackedOp (common/tracked_op.py) — the
        scheduler marks `queued` / `dequeued` on its timeline so queue
        wait is attributable per op (reference OpTracker events around
        the OSD op queue)."""
        if top is not None and getattr(top, "is_tracked", False):
            top.mark_event("queued")
            inner = fn

            def fn():
                top.mark_event("dequeued")
                inner()
        with self._cv:
            if isinstance(self.scheduler, MClockScheduler):
                self.scheduler.enqueue(fn, op_class=op_class)
            else:
                self.scheduler.enqueue(
                    fn, priority=priority,
                    strict=(op_class == "client" and priority >= 196))
            self._cv.notify()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while self.scheduler.empty() and not self._stop:
                    self._cv.wait(0.5)
                # stop once the backlog is drained (queued ops were
                # accepted — dropping them would strand their clients
                # until the op timeout), or IMMEDIATELY on abort (the
                # drain grace expired: the daemon is tearing down its
                # messenger/store, and ops applied past that point
                # could race a revived daemon on the same store)
                if self._abort or (self._stop and
                                   self.scheduler.empty()):
                    return
                fn = self.scheduler.dequeue()
            if fn is not None:
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    import traceback
                    traceback.print_exc()

    def drain_and_stop(self, grace: float = 2.0) -> None:
        """Workers drain the accepted backlog for up to `grace`
        seconds, then abort — a bounded teardown window, unlike the
        executor's shutdown(wait=False) which keeps running every
        already-queued task unboundedly."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        deadline = time.monotonic() + grace
        for t in self.threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._cv:
            self._abort = True
            self._cv.notify_all()
        for t in self.threads:
            t.join(timeout=1)

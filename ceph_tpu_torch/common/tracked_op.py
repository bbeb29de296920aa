"""TrackedOp/OpTracker: per-request event timelines and slow-op latching.

Re-expresses the reference's op tracking subsystem
(src/common/TrackedOp.{h,cc}: TrackedOp::mark_event / OpTracker ::
RegisterOnFlight + History, consumed by `dump_ops_in_flight`,
`dump_historic_ops`, `dump_historic_slow_ops` and the slow-request
health warning path in OSD::check_ops_in_flight) crossed with
Dapper-style trace propagation (Sigelman et al., 2010): every op
carries a TraceContext (trace id + span id + parent span) that rides
messenger messages, so the client's objecter span, the primary's op
span and each shard-holder's sub-op span stitch into one tree keyed by
trace id.

Design constraints (the subsystem is ALWAYS ON in the daemons):

- Tracing-off fast path: with the tracker disabled, `create()` returns
  the shared NULL_TRACKED singleton whose every method is a no-op —
  zero allocations, zero timestamps, zero lock traffic per op.
- Cheap events: `mark_event` is one `time.time()` + one list append
  (atomic under the GIL); no locks on the hot path.  The tracker lock
  is taken only on register/unregister (deque ops) and dumps.
- Bounded memory: in-flight ops live in a dict; completed ops move to
  a bounded ring (`history_size`), slow ops additionally latch into
  their own bounded ring (`history_slow_size`) — the reference's
  OpHistory double ring.
- Per-stage blame: a slow op names the stage that consumed the most
  wall time (for completed ops: the largest inter-event gap; for
  stuck in-flight ops: the time since the last event), so "which op,
  stuck at which stage, on which shard?" has an answer.
"""

from __future__ import annotations

import collections
import threading
import time
import uuid


class TraceContext:
    """Dapper-style trace context: (trace_id, span_id, parent_span).

    trace_id identifies the whole request tree; span_id this hop's
    span; parent_span the span that caused it.  Wire form is a small
    JSON dict riding message meta (see msg/messages.py `trace` fields).
    """

    __slots__ = ("trace_id", "span_id", "parent_span", "origin_ts")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span: str | None = None,
                 origin_ts: float | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span = parent_span
        # wall-clock of the root submit, carried along so downstream
        # daemons can place "objecter_submit" on their timelines
        self.origin_ts = origin_ts

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(uuid.uuid4().hex[:16], uuid.uuid4().hex[:8],
                   None, time.time())

    def child(self) -> "TraceContext":
        """A child span of this one (same trace, fresh span id)."""
        return TraceContext(self.trace_id, uuid.uuid4().hex[:8],
                            self.span_id, self.origin_ts)

    def to_wire(self) -> dict:
        w = {"id": self.trace_id, "span": self.span_id}
        if self.parent_span is not None:
            w["parent"] = self.parent_span
        if self.origin_ts is not None:
            w["ts"] = self.origin_ts
        return w

    @classmethod
    def from_wire(cls, w: dict | None) -> "TraceContext | None":
        if not w or "id" not in w:
            return None
        return cls(str(w["id"]), str(w.get("span", "")),
                   w.get("parent"), w.get("ts"))


def canonical_stage(event: str) -> str:
    """Histogram key for an event: per-shard detail stripped, so
    sub_write_ack(2) and sub_write_ack(0) share one latency series."""
    i = event.find("(")
    return event if i < 0 else event[:i]


class TrackedOp:
    """One in-flight (then historic) operation with an event timeline.

    Events are (wall_ts, name) pairs; wall clock (not monotonic) so
    timelines from different daemons of one trace can be merged — the
    reference's utime_t event stamps make the same choice.
    """

    __slots__ = ("tracker", "op_type", "desc", "trace", "events",
                 "initiated_at", "completed_at", "result", "info",
                 "slow", "slow_since", "blamed_stage", "_unregistered")

    def __init__(self, tracker: "OpTracker | None", op_type: str,
                 desc: str, trace: TraceContext | None = None):
        self.tracker = tracker
        self.op_type = op_type
        self.desc = desc
        provided = trace is not None
        self.trace = trace if provided else TraceContext.new()
        self.initiated_at = time.time()
        self.completed_at: float | None = None
        self.events: list[tuple[float, str]] = []
        self.result: int | None = None
        self.info: dict = {}         # pg / version / client-visible tags
        self.slow = False
        self.slow_since: float | None = None
        self.blamed_stage: str | None = None
        self._unregistered = False
        # the origin (objecter submit) event, when a CALLER-supplied
        # trace carried it, anchors the timeline before any local
        # event — only on root spans (a sub-op span starts at its own
        # hop, not at the client; a self-created trace has no remote
        # origin to anchor)
        if provided and self.trace.origin_ts is not None and \
                self.trace.parent_span is None:
            self.events.append((self.trace.origin_ts, "objecter_submit"))

    # -- hot path -----------------------------------------------------------

    def mark_event(self, name: str, ts: float | None = None) -> None:
        self.events.append((ts if ts is not None else time.time(), name))

    def set_info(self, key: str, value) -> None:
        self.info[key] = value

    # -- introspection -------------------------------------------------------

    @property
    def is_tracked(self) -> bool:
        return True

    def age(self, now: float | None = None) -> float:
        return (now if now is not None else time.time()) - \
            self.initiated_at

    def duration(self) -> float:
        end = self.completed_at if self.completed_at is not None \
            else time.time()
        return end - self.initiated_at

    def current_stage(self) -> str:
        return self.events[-1][1] if self.events else "initiated"

    def stage_durations(self) -> list[tuple[str, float]]:
        """[(event_name, seconds spent reaching it)] — the interval is
        attributed to the event that ENDS it (waiting for sub_write_ack
        is blamed on sub_write_ack, not on the send that preceded it)."""
        out = []
        prev = self.initiated_at
        for ts, name in self.events:
            out.append((name, max(0.0, ts - prev)))
            prev = ts
        return out

    def blame(self, now: float | None = None) -> str:
        """The stage that ate the op's wall time (see module doc)."""
        now = now if now is not None else time.time()
        gaps = self.stage_durations()
        if self.completed_at is None and self.events:
            # still in flight: time stalled past the last event counts
            # as a gap "inside" the current stage
            gaps.append((f"waiting after {self.events[-1][1]}",
                         now - self.events[-1][0]))
        if not gaps:
            return "initiated"
        return max(gaps, key=lambda g: g[1])[0]

    def to_dict(self, now: float | None = None) -> dict:
        now = now if now is not None else time.time()
        d = {
            "type": self.op_type,
            "description": self.desc,
            "trace_id": self.trace.trace_id,
            "span_id": self.trace.span_id,
            "parent_span": self.trace.parent_span,
            "initiated_at": self.initiated_at,
            "age": round(self.age(now), 6),
            "duration": round(self.duration(), 6),
            "current_stage": self.current_stage(),
            "events": [{"ts": ts, "event": name}
                       for ts, name in self.events],
        }
        if self.result is not None:
            d["result"] = self.result
        if self.slow:
            d["slow"] = True
            d["blamed_stage"] = self.blamed_stage
        d.update(self.info)
        return d


class _NullTrackedOp:
    """The tracing-off fast path: one shared instance, every method a
    no-op (reference: OpTracker::create_request returns early when
    tracking_enabled is false).  Identity-comparable via NULL_TRACKED."""

    __slots__ = ()

    trace = None
    events: tuple = ()
    info: dict = {}
    op_type = desc = ""
    slow = False
    blamed_stage = None
    result = None
    initiated_at = completed_at = 0.0

    @property
    def is_tracked(self) -> bool:
        return False

    def mark_event(self, name: str, ts: float | None = None) -> None:
        pass

    def set_info(self, key: str, value) -> None:
        pass

    def age(self, now: float | None = None) -> float:
        return 0.0

    def duration(self) -> float:
        return 0.0

    def current_stage(self) -> str:
        return ""

    def stage_durations(self) -> list:
        return []

    def blame(self, now: float | None = None) -> str:
        return ""

    def to_dict(self, now: float | None = None) -> dict:
        return {}


NULL_TRACKED = _NullTrackedOp()

# only client-request op types feed the SLOW_OPS complaint path:
# background recovery/scrub ops legitimately outlive complaint_time
# (the reference warns on slow *requests*, never on background work)
COMPLAINT_OP_TYPES = frozenset({"osd_op", "ec_sub_write"})


class OpTracker:
    """Per-daemon registry of tracked ops (reference OpTracker).

    perf: optional PerfCounters with histogram support — on op
    completion every stage interval lands in a `lat_<stage>` latency
    histogram (common/perf_counters.py HISTOGRAM type), exported by
    tools/metrics_exporter.py.
    """

    def __init__(self, enabled: bool = True,
                 complaint_time: float = 30.0,
                 history_size: int = 20,
                 history_slow_size: int = 20,
                 perf=None):
        self.enabled = enabled
        self.complaint_time = complaint_time
        self.history_size = history_size
        self.perf = perf
        self._lock = threading.Lock()
        self._inflight: dict[int, TrackedOp] = {}
        self._history: collections.deque[TrackedOp] = \
            collections.deque(maxlen=history_size)
        self._slow_history: collections.deque[TrackedOp] = \
            collections.deque(maxlen=history_slow_size)
        # monotonic counters for the health report
        self.num_tracked = 0
        self.num_slow = 0

    # -- lifecycle -----------------------------------------------------------

    def create(self, op_type: str, desc: str = "",
               trace: TraceContext | None = None):
        """New tracked op (registered in flight) — or NULL_TRACKED when
        tracking is off (the zero-cost path)."""
        if not self.enabled:
            return NULL_TRACKED
        top = TrackedOp(self, op_type, desc, trace)
        with self._lock:
            self._inflight[id(top)] = top
            self.num_tracked += 1
        return top

    def unregister(self, top, result: int | None = None) -> None:
        """Op finished: move to the historic ring; latch as slow when
        it exceeded the complaint time; feed the stage histograms."""
        if top is NULL_TRACKED or not getattr(top, "is_tracked", False):
            return
        if top._unregistered:       # idempotent (error paths may race)
            return
        top._unregistered = True
        top.completed_at = time.time()
        if result is not None:
            top.result = result
        newly_slow = False
        if self.complaint_time > 0 and \
                top.op_type in COMPLAINT_OP_TYPES and \
                top.duration() > self.complaint_time:
            newly_slow = not top.slow
            if newly_slow:
                top.slow = True
                top.slow_since = top.completed_at
            # final blame from the COMPLETE timeline: an op the
            # in-flight scanner latched carries a provisional
            # "waiting after X" (the stall was still open when it was
            # scanned) — once the op finishes, the stage that actually
            # ended the wait (e.g. a late msgr_send(peer)) owns it
            top.blamed_stage = top.blame()
        with self._lock:
            self._inflight.pop(id(top), None)
            self._history.append(top)
            if newly_slow:      # in-flight latching already ringed it
                self.num_slow += 1
                self._slow_history.append(top)
        if self.perf is not None:
            for name, dt in top.stage_durations():
                self.perf.hinc(f"lat_{canonical_stage(name)}", dt)
            # end-to-end per-op-type series: the p99 every per-stage
            # series decomposes (dump_latencies / the exporter's
            # precomputed tail gauges read it like any stage)
            self.perf.hinc(f"lat_total_{top.op_type}", top.duration())

    # -- slow-op surveillance ------------------------------------------------

    def check_ops_in_flight(self, now: float | None = None
                            ) -> list[TrackedOp]:
        """Latch in-flight ops older than the complaint time (the
        reference's visit_ops_in_flight + slow-request warning).
        Returns every CURRENTLY slow in-flight op; newly latched ones
        also enter the slow history ring."""
        if not self.enabled or self.complaint_time <= 0:
            return []
        now = now if now is not None else time.time()
        slow: list[TrackedOp] = []
        newly: list[TrackedOp] = []
        with self._lock:
            for top in self._inflight.values():
                if top.op_type in COMPLAINT_OP_TYPES and \
                        top.age(now) > self.complaint_time:
                    if not top.slow:
                        top.slow = True
                        top.slow_since = now
                        newly.append(top)
                        self.num_slow += 1
                        self._slow_history.append(top)
                    top.blamed_stage = top.blame(now)
                    slow.append(top)
        return slow

    def slow_op_summary(self, window: float | None = None) -> dict:
        """The OSD->mon health payload: slow in-flight ops plus ops
        that latched within the recency `window` (a slow write that
        finally commits must not flicker the health warning off before
        anyone sees it).  Consumed by mon/monitor.py `health`."""
        inflight = self.check_ops_in_flight()
        now = time.time()
        if window is None:
            window = max(2.0, min(60.0, 2 * self.complaint_time))
        seen = {id(t) for t in inflight}
        recent = []
        with self._lock:
            for t in self._slow_history:
                if id(t) not in seen and t.completed_at is not None \
                        and t.slow_since is not None and \
                        now - t.slow_since <= window:
                    recent.append(t)
        slow = inflight + recent
        return {
            "count": len(slow),
            "oldest_age": round(max(
                [t.age(now) for t in inflight] +
                [t.duration() for t in recent], default=0.0), 3),
            "total_slow": self.num_slow,
            "ops": [{"type": t.op_type, "desc": t.desc,
                     "trace_id": t.trace.trace_id,
                     "age": round(t.age(now) if t.completed_at is None
                                  else t.duration(), 3),
                     "blamed_stage": t.blamed_stage,
                     # op owner (the PG primary) when known: the mon
                     # names IT in the SLOW_OPS daemons list, so a
                     # replica's sub-op report blames the right daemon
                     "primary": t.info.get("primary")}
                    for t in slow[:10]],
        }

    # -- dumps (asok command backends) ---------------------------------------

    def dump_ops_in_flight(self) -> dict:
        now = time.time()
        with self._lock:
            ops = [t.to_dict(now) for t in self._inflight.values()]
        ops.sort(key=lambda d: d["initiated_at"])
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> dict:
        now = time.time()
        with self._lock:
            ops = [t.to_dict(now) for t in self._history]
        return {"num_ops": len(ops), "size": self.history_size,
                "ops": ops}

    def dump_historic_slow_ops(self) -> dict:
        now = time.time()
        with self._lock:
            ops = [t.to_dict(now) for t in self._slow_history]
        return {"num_ops": len(ops), "complaint_time":
                self.complaint_time, "ops": ops}

    def get_historic(self, trace_id: str) -> list[TrackedOp]:
        """Historic ops of one trace (test/debug convenience)."""
        with self._lock:
            return [t for t in self._history
                    if t.trace.trace_id == trace_id]

"""Control-plane flight recorder (docs/TRACING.md "Control plane").

The device plane attributes every launch (ops/profiler.py); this is
the same discipline applied to the OSD's *state machine*: every
peering / recovery / backfill transition of every led PG lands in a
bounded per-PG ring with a monotonic sequence number, every recovery
stage (peering round, wide scan, batched decode, shard push, throttle
wait) is timed into `lat_peering_*` / `lat_recovery_*` histograms on
the control-plane bucket axis, and the O(peers) costs ROADMAP item 4
names — remote collection listings per re-peered PG, objects scanned
vs objects actually recovered, throttle waits — are counted so the
superlinear fan-out term at 128-256 OSDs shows up as a measured curve
instead of folklore.

Re-expresses the reference's PeeringState event tracking (
`pg <id> query` state history + osd_pg_log scan accounting) and the
degraded-window bookkeeping behind `ceph health`'s PG_DEGRADED detail.

One ledger per OSD daemon — peering and recovery are per-daemon work,
so unlike the host-singleton device profiler there is no perf-owner
problem: every daemon registers its own perf set and ships its own
`ledger` block on MPGStats (mon/monitor.py consumes it for the
"since <ts>" degraded detail, the mgr progress module for completion
fractions).

Surfaces:
  - `pg ledger` asok (tools/ceph_cli.py daemon mode) — full dump
  - pgstats_block() — the MPGStats "ledger" block (cumulative,
    rounded, so the keepalive dedup in _pgstats_should_send still
    sees steady-state reports as unchanged)
  - blame_block() — the `recovery_blame` decomposition source for
    cluster_bench --scale rows
  - pg_state_counts() — per-pool state counts for the prometheus
    exporter's ceph_tpu_pg_state{state=...} gauges
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..common.perf_counters import (CONTROL_LAT_BUCKETS,
                                    PerfCountersBuilder)

# recovery stages the blame decomposition names (cluster_bench
# --scale `recovery_blame`): wall seconds spent in each per PG
STAGES = ("peering", "scan", "decode", "push", "throttle")

# counted O(peers) costs (ROADMAP item 4)
COUNTERS = ("remote_lists", "objects_scanned", "objects_recovered")


def _build_ledger_perf(name: str):
    b = (PerfCountersBuilder(name)
         .add_u64_counter("pg_transitions",
                          "PG state-machine transitions recorded")
         .add_u64_counter("pg_remote_lists",
                          "remote collection listings issued by "
                          "peering/recovery scans")
         .add_u64_counter("pg_objects_scanned",
                          "objects examined by recovery passes")
         .add_u64_counter("pg_objects_recovered",
                          "objects actually rebuilt/adopted/pushed")
         .add_u64_counter("pg_degraded_windows",
                          "degraded windows closed (PG returned to "
                          "full redundancy)")
         .add_u64_counter("pg_degraded_acked_writes",
                          "client writes acked while the PG served "
                          "below full redundancy (>= min_size)")
         .add_gauge("pg_degraded_open_windows",
                    "PGs currently inside an open degraded window")
         .add_histogram("lat_peering_total",
                        "wall seconds of one peering/reconcile round",
                        buckets=CONTROL_LAT_BUCKETS)
         .add_histogram("lat_recovery_scan",
                        "wall seconds of one recovery name-scan "
                        "(remote listings + filters)",
                        buckets=CONTROL_LAT_BUCKETS)
         .add_histogram("lat_recovery_decode",
                        "wall seconds of one batched "
                        "reconstruct-from-k pass",
                        buckets=CONTROL_LAT_BUCKETS)
         .add_histogram("lat_recovery_push",
                        "wall seconds of one rebuilt-shard push",
                        buckets=CONTROL_LAT_BUCKETS)
         .add_histogram("lat_recovery_throttle",
                        "wall seconds a recovery push spent in the "
                        "bandwidth throttle gate",
                        buckets=CONTROL_LAT_BUCKETS)
         .add_histogram("lat_degraded_window",
                        "wall seconds a degraded window stayed open",
                        buckets=CONTROL_LAT_BUCKETS))
    return b.create_perf_counters()


class _PGRecord:
    """Per-PG ledger state: the transition ring plus stage/counter
    accumulators.  Mutated under the GIL like perf counters — the
    hot-path writers are single attribute updates."""

    __slots__ = ("transitions", "state", "state_since", "last_seq",
                 "stage_s", "counters", "degraded_since",
                 "degraded_windows", "degraded_acked", "epoch")

    def __init__(self, ring: int):
        self.transitions: deque = deque(maxlen=ring)
        self.state = "new"
        self.state_since = time.time()
        self.last_seq = 0
        self.stage_s = dict.fromkeys(STAGES, 0.0)
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.degraded_since: float | None = None
        self.degraded_windows = 0
        self.degraded_acked = 0
        self.epoch = 0

    def to_dict(self, last: int | None = None) -> dict:
        trans = list(self.transitions)
        if last is not None:
            trans = trans[-last:]
        d = {
            "state": self.state,
            "state_since": round(self.state_since, 3),
            "epoch": self.epoch,
            "stages_s": {k: round(v, 6)
                         for k, v in self.stage_s.items()},
            "counters": dict(self.counters),
            "degraded": {
                "open_since": (round(self.degraded_since, 3)
                               if self.degraded_since is not None
                               else None),
                "windows": self.degraded_windows,
                "acked_writes": self.degraded_acked,
            },
            "transitions": [
                {"seq": seq, "ts": round(ts, 3), "epoch": ep,
                 "from": frm, "to": to, "dur_s": round(dur, 6)}
                for seq, ts, ep, frm, to, dur in trans],
        }
        return d


class _Stage:
    """Times one recovery stage into the ledger (context manager)."""

    __slots__ = ("led", "pgid", "name", "t0")

    def __init__(self, led: "PGLedger", pgid, name: str):
        self.led = led
        self.pgid = pgid
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.led._add_stage(self.pgid, self.name,
                            time.perf_counter() - self.t0)
        return False


class _NullStage:
    """The ledger-off fast path: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_STAGE = _NullStage()


class PGLedger:
    """Per-daemon PG state-machine ledger (module doc).  `enabled`
    gates every entry point on one attribute check; the off path
    allocates nothing (the NULL_TRACKED rule)."""

    def __init__(self, name: str = "pg_ledger", ring: int = 64,
                 perf=None):
        self.enabled = True
        self.ring = max(1, int(ring))
        self.perf = perf if perf is not None \
            else _build_ledger_perf(name)
        self._lock = threading.Lock()
        self._pgs: dict = {}          # pg_t -> _PGRecord
        self._seq = 0                 # daemon-wide monotonic sequence
        self._t0 = time.time()

    # -- record access ------------------------------------------------------

    def _rec(self, pgid) -> _PGRecord:
        rec = self._pgs.get(pgid)
        if rec is None:
            with self._lock:
                rec = self._pgs.get(pgid)
                if rec is None:
                    rec = _PGRecord(self.ring)
                    self._pgs[pgid] = rec
        return rec

    # -- hot-path entry points ----------------------------------------------

    def transition(self, pgid, state: str, epoch: int = 0) -> None:
        """One state-machine transition: timestamped ring entry with a
        daemon-wide monotonic seq; the time spent in the PREVIOUS
        state rides the entry (the reference's state-duration dump)."""
        if not self.enabled:
            return
        now = time.time()
        rec = self._rec(pgid)
        with self._lock:
            self._seq += 1
            seq = self._seq
        rec.transitions.append((seq, now, epoch, rec.state, state,
                                max(0.0, now - rec.state_since)))
        rec.state = state
        rec.state_since = now
        rec.last_seq = seq
        if epoch:
            rec.epoch = epoch
        self.perf.inc("pg_transitions")

    def stage(self, pgid, name: str):
        """Context manager timing one recovery stage (STAGES) for one
        PG; NULL_STAGE when the ledger is off."""
        if not self.enabled:
            return NULL_STAGE
        return _Stage(self, pgid, name)

    def _add_stage(self, pgid, name: str, dt: float) -> None:
        rec = self._rec(pgid)
        rec.stage_s[name] = rec.stage_s.get(name, 0.0) + dt
        key = "lat_peering_total" if name == "peering" \
            else f"lat_recovery_{name}"
        self.perf.hinc(key, dt)

    def count(self, pgid, key: str, n: int = 1) -> None:
        if not self.enabled:
            return
        rec = self._rec(pgid)
        rec.counters[key] = rec.counters.get(key, 0) + n
        self.perf.inc(f"pg_{key}", n)

    # -- degraded windows ---------------------------------------------------

    def degraded_open(self, pgid) -> None:
        """Open the PG's degraded window; idempotent while open."""
        if not self.enabled:
            return
        rec = self._rec(pgid)
        if rec.degraded_since is None:
            rec.degraded_since = time.time()
            self.perf.inc("pg_degraded_open_windows")

    def degraded_close(self, pgid) -> bool:
        """Close the PG's degraded window.  Returns True only for the
        close that actually ended an open window — callers may close
        redundantly (every clean recovery pass does), the window still
        closes exactly once."""
        if not self.enabled:
            return False
        rec = self._pgs.get(pgid)
        if rec is None or rec.degraded_since is None:
            return False
        dur = max(0.0, time.time() - rec.degraded_since)
        rec.degraded_since = None
        rec.degraded_windows += 1
        self.perf.inc("pg_degraded_windows")
        self.perf.inc("pg_degraded_open_windows", -1)
        self.perf.hinc("lat_degraded_window", dur)
        return True

    def degraded_ack(self, pgid) -> None:
        """One client write acked while the PG served below full
        redundancy (>= min_size, < size): the risk the degraded
        window exists to bound.  Opens the window when the write is
        the first degraded event seen for the PG."""
        if not self.enabled:
            return
        rec = self._rec(pgid)
        if rec.degraded_since is None:
            rec.degraded_since = time.time()
            self.perf.inc("pg_degraded_open_windows")
        rec.degraded_acked += 1
        self.perf.inc("pg_degraded_acked_writes")

    # -- aggregation surfaces -----------------------------------------------

    def totals(self) -> dict:
        """Daemon-wide cumulative stage seconds + counters."""
        with self._lock:
            recs = list(self._pgs.values())
        out = {f"{k}_s": 0.0 for k in STAGES}
        for k in COUNTERS:
            out[k] = 0
        out["transitions"] = 0
        out["degraded_windows"] = 0
        out["degraded_acked"] = 0
        open_since = []
        for rec in recs:
            for k in STAGES:
                out[f"{k}_s"] += rec.stage_s.get(k, 0.0)
            for k in COUNTERS:
                out[k] += rec.counters.get(k, 0)
            out["transitions"] += len(rec.transitions)
            out["degraded_windows"] += rec.degraded_windows
            out["degraded_acked"] += rec.degraded_acked
            if rec.degraded_since is not None:
                open_since.append(rec.degraded_since)
        out["degraded_open"] = len(open_since)
        out["degraded_oldest_since"] = (round(min(open_since), 3)
                                        if open_since else None)
        for k in STAGES:
            out[f"{k}_s"] = round(out[f"{k}_s"], 6)
        return out

    def pgstats_block(self) -> dict | None:
        """The MPGStats "ledger" block: cumulative totals, values
        rounded coarsely so a quiescent daemon's report stays
        bit-identical between stat windows and the keepalive dedup
        (_pgstats_should_send) keeps working.  None when the ledger
        has recorded nothing (boot-time reports stay lean)."""
        if not self.enabled:
            return None
        t = self.totals()
        if not t["transitions"] and not t["degraded_open"]:
            return None
        return {
            "peering_s": round(t["peering_s"], 2),
            "scan_s": round(t["scan_s"], 2),
            "decode_s": round(t["decode_s"], 2),
            "push_s": round(t["push_s"], 2),
            "throttle_s": round(t["throttle_s"], 2),
            "remote_lists": t["remote_lists"],
            "objects_scanned": t["objects_scanned"],
            "objects_recovered": t["objects_recovered"],
            "transitions": t["transitions"],
            "degraded_open": t["degraded_open"],
            "degraded_oldest_since": t["degraded_oldest_since"],
            "degraded_acked": t["degraded_acked"],
        }

    def blame_block(self) -> dict:
        """Cumulative decomposition source for cluster_bench --scale
        `recovery_blame` rows: callers snapshot before churn and diff
        after active+clean."""
        t = self.totals()
        return {k: t[k] for k in
                ("peering_s", "scan_s", "decode_s", "push_s",
                 "throttle_s", "remote_lists", "objects_scanned",
                 "objects_recovered", "transitions",
                 "degraded_windows", "degraded_acked")}

    def pg_state_counts(self) -> dict:
        """{pool_id: {state: count}} of current per-PG states — the
        exporter's ceph_tpu_pg_state{state=...} gauge source."""
        with self._lock:
            items = list(self._pgs.items())
        out: dict = {}
        for pgid, rec in items:
            pool = getattr(pgid, "pool", -1)
            pool_states = out.setdefault(pool, {})
            pool_states[rec.state] = pool_states.get(rec.state, 0) + 1
            if rec.degraded_since is not None:
                pool_states["degraded"] = \
                    pool_states.get("degraded", 0) + 1
        return out

    def dump(self, last: int | None = 8) -> dict:
        """The `pg ledger` asok payload."""
        with self._lock:
            items = sorted(self._pgs.items(), key=lambda kv: str(kv[0]))
        return {
            "enabled": self.enabled,
            "ring_size": self.ring,
            "uptime_s": round(time.time() - self._t0, 3),
            "totals": self.totals(),
            "latencies": self.perf.dump_latencies(),
            "pgs": {str(pgid): rec.to_dict(last)
                    for pgid, rec in items},
        }

    def reset(self) -> None:
        """Drop per-PG state (perf histograms stay monotonic, like
        the device profiler's reset)."""
        with self._lock:
            self._pgs.clear()
            self._seq = 0
            self._t0 = time.time()

    def set_ring_size(self, ring: int) -> None:
        self.ring = max(1, int(ring))
        with self._lock:
            for rec in self._pgs.values():
                rec.transitions = deque(rec.transitions,
                                        maxlen=self.ring)

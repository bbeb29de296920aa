"""Wire-plane flight recorder (docs/TRACING.md "Wire plane").

The device plane attributes every launch (ops/profiler.py), the
control plane every PG transition (osd/pg_ledger.py); this is the
same discipline applied to the layer that connects them — the async
messenger.  The shared reactor pool's RT was seen to exceed 10 s
right after boot with no counter that named why, and recovery
fan-out at 128-256 OSDs needs per-peer wire accounting to be
diagnosable at all.  The reference
instruments exactly this layer (AsyncMessenger worker + DispatchQueue
perf counters, Throttle accounting); this module re-expresses that
surface on the asyncio reactor pool:

* **Per-connection ledger** — every frame sent/received lands in a
  bounded per-peer table (oldest peer evicted, ring-style): msgs and
  bytes in/out by message TYPE (bounded by-type dicts, overflow under
  "other"), send-queue depth high-water (len(sess.unacked) at send),
  reconnects, replayed frames, compressed/encrypted wire bytes.
  Surfaced by the `messenger status` / `conn profile` asoks on every
  daemon (tools/ceph_cli.py daemon mode).

* **Reactor health** — a per-reactor loop-lag probe: a callback
  rescheduling itself every ms_reactor_lag_interval seconds measures
  scheduled-vs-actual fire time (the OSD heartbeat tick-lag detector's
  rule: the gauge moves every tick, an EVENT counts only when the
  probe fired a FULL extra interval late).  Lag samples feed
  `lat_msgr_reactor_lag`; events enter a bounded window that ships
  monward.  The dispatch executor is timed the same way: submit->run
  wait in `lat_msgr_qwait`, handler run in `lat_msgr_dispatch`, both
  on the shared DEFAULT_LAT_BUCKETS axis so `dump_latencies`, the
  exporter's percentile gauges and the load harness pick them up
  unchanged — "reactor starved" vs "dispatcher slow" vs "peer slow"
  becomes attributable.

* **Trace stitching** — the send path stamps `msgr_send(peer)` onto
  tracked ops riding a frame (msg._top), and the OSD ingest path
  stamps `msgr_recv_lag`, so slow-op blame can say "5.1 s in the send
  queue to osd.7" the way it already says "waited on first-compile of
  bucket X" (Dapper-style stitching, Sigelman et al. 2010; tail
  blame, Dean & Barroso 2013).

* **Aggregation upward** — pgstats_block() rides MPGStats to the mon
  (MSGR_REACTOR_LAG health warning naming the worst daemon/reactor),
  bench_summary() embeds in cluster_bench --scale rows beside
  recovery_blame, and the per-messenger counter set registers into
  each daemon's perf collection for ceph_tpu_msgr_* exporter gauges.

* **Always on, null when off** — enabled by default (conf ms_ledger);
  disabled, every entry point returns after ONE attribute check and
  allocates nothing (the NULL_TRACKED rule).  On-path overhead is
  gated <= 2% in bench.py --smoke like the device/control planes.

Perf-owner rule: the process-wide ledger's perf set (reactor lag +
dispatch histograms — the reactors and executor are shared by every
in-process daemon) registers into exactly ONE daemon's collection via
the `_perf_registered` attribute check (the DeviceProfiler pattern);
that daemon ships the monward block.  Each Messenger's OWN counter
set (MsgrStats) is per-instance, so every daemon exports its own wire
totals without n_daemons-fold inflation.
"""

from __future__ import annotations

import collections
import threading
import time

from ..common.perf_counters import PerfCountersBuilder

# per-peer by-type maps are bounded: past this many distinct message
# type names, further types count under "other" (a fuzzer or a newer
# peer's unknown types must not grow the table)
TYPE_CAP = 32
OTHER_TYPE = "other"


def _build_ledger_perf(name: str = "msgr_ledger"):
    """The process-shared set: reactor + dispatch-executor health
    (registered into ONE daemon per process — see module doc)."""
    return (PerfCountersBuilder(name)
            .add_u64_counter("msgr_dispatches",
                             "handler runs completed through the "
                             "shared dispatch executor")
            .add_u64_counter("msgr_reactor_lag_events",
                             "reactor lag probes that fired a FULL "
                             "extra interval late (the tick-lag rule)")
            .add_gauge("msgr_dispatch_queued",
                       "dispatch-executor submissions currently "
                       "queued or running")
            .add_gauge("msgr_dispatch_queued_hwm",
                       "high-water of msgr_dispatch_queued")
            .add_gauge("msgr_reactor_lag_worst",
                       "worst last-probe loop lag across reactors "
                       "(seconds)")
            .add_histogram("lat_msgr_reactor_lag",
                           "per-probe reactor loop lag "
                           "(scheduled vs actual fire time)")
            .add_histogram("lat_msgr_qwait",
                           "dispatch-executor queue wait "
                           "(submit -> handler start)")
            .add_histogram("lat_msgr_dispatch",
                           "dispatch handler run time")
            .create_perf_counters())


def _build_msgr_perf(name: str = "msgr"):
    """One Messenger instance's counter set — registered into ITS
    daemon's collection (per-daemon ceph_tpu_msgr_* exporter gauges)."""
    return (PerfCountersBuilder(name)
            .add_u64_counter("msgr_msgs_out", "messages sent")
            .add_u64_counter("msgr_msgs_in", "messages received")
            .add_u64_counter("msgr_bytes_out", "frame bytes sent")
            .add_u64_counter("msgr_bytes_in", "frame bytes received")
            .add_u64_counter("msgr_reconnects",
                             "reconnect rounds entered after a wire "
                             "fault")
            .add_u64_counter("msgr_replay_frames",
                             "retained frames replayed to a resumed "
                             "session")
            .add_u64_counter("msgr_sync_timeouts",
                             "_run_sync bridge calls that expired "
                             "(conf ms_sync_timeout)")
            .add_u64_counter("msgr_compress_bytes",
                             "wire bytes written through the "
                             "compression wrap")
            .add_u64_counter("msgr_encrypt_bytes",
                             "wire bytes written through the AES-GCM "
                             "wrap")
            .add_gauge("msgr_sendq_hwm",
                       "send-queue (unacked window) depth high-water "
                       "across peers")
            .create_perf_counters())


def _type_inc(table: dict, mtype: str, by: int = 1) -> None:
    n = table.get(mtype)
    if n is None and len(table) >= TYPE_CAP:
        mtype = OTHER_TYPE
        n = table.get(mtype)
    table[mtype] = (n or 0) + by


class ConnStats:
    """One peer's wire accounting (bounded table entry, see module
    doc).  Mutated with plain attribute updates under the GIL, like
    perf counters — the hot-path writers are single updates."""

    __slots__ = ("peer", "msgs_out", "msgs_in", "bytes_out", "bytes_in",
                 "out_types", "in_types", "sendq_hwm", "reconnects",
                 "replay_frames", "compress_bytes", "encrypt_bytes",
                 "first_ts", "last_ts")

    def __init__(self, peer: str):
        self.peer = peer
        self.msgs_out = 0
        self.msgs_in = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.out_types: dict[str, int] = {}
        self.in_types: dict[str, int] = {}
        self.sendq_hwm = 0
        self.reconnects = 0
        self.replay_frames = 0
        self.compress_bytes = 0
        self.encrypt_bytes = 0
        self.first_ts = time.time()
        self.last_ts = self.first_ts

    def to_dict(self) -> dict:
        return {
            "peer": self.peer,
            "msgs_out": self.msgs_out,
            "msgs_in": self.msgs_in,
            "bytes_out": self.bytes_out,
            "bytes_in": self.bytes_in,
            "out_types": dict(self.out_types),
            "in_types": dict(self.in_types),
            "sendq_hwm": self.sendq_hwm,
            "reconnects": self.reconnects,
            "replay_frames": self.replay_frames,
            "compress_bytes": self.compress_bytes,
            "encrypt_bytes": self.encrypt_bytes,
            "first_ts": round(self.first_ts, 3),
            "last_ts": round(self.last_ts, 3),
        }


class MsgrStats:
    """One Messenger's ledger slice: its own perf set plus the bounded
    per-peer table.  Every entry point is called BEHIND the ledger's
    enabled check (the messenger hooks gate on it), so there is no
    second gate here."""

    def __init__(self, name: str, ledger: "MsgrLedger", perf=None,
                 peer_cap: int = 256):
        self.name = name
        self.ledger = ledger
        self.perf = perf if perf is not None else _build_msgr_perf()
        self.peer_cap = max(1, int(peer_cap))
        self._lock = threading.Lock()
        # insertion-ordered, oldest evicted past peer_cap: the bounded
        # per-peer "ring" (a churny client swarm must not grow it)
        self._peers: collections.OrderedDict[str, ConnStats] = \
            collections.OrderedDict()
        self.sendq_hwm = 0
        self.sync_timeouts = 0

    def _peer(self, key: str) -> ConnStats:
        p = self._peers.get(key)
        if p is None:
            with self._lock:
                p = self._peers.get(key)
                if p is None:
                    p = ConnStats(key)
                    self._peers[key] = p
                    while len(self._peers) > self.peer_cap:
                        self._peers.popitem(last=False)
        return p

    # -- hot-path entry points ----------------------------------------------

    def note_send(self, peer: str, mtype: str, nbytes: int,
                  sendq_depth: int) -> None:
        p = self._peer(peer)
        p.msgs_out += 1
        p.bytes_out += nbytes
        _type_inc(p.out_types, mtype)
        p.last_ts = time.time()
        if sendq_depth > p.sendq_hwm:
            p.sendq_hwm = sendq_depth
            if sendq_depth > self.sendq_hwm:
                self.sendq_hwm = sendq_depth
                self.perf.set("msgr_sendq_hwm", sendq_depth)
        self.perf.inc("msgr_msgs_out")
        self.perf.inc("msgr_bytes_out", nbytes)

    def note_recv(self, peer: str, mtype: str, nbytes: int) -> None:
        p = self._peer(peer)
        p.msgs_in += 1
        p.bytes_in += nbytes
        _type_inc(p.in_types, mtype)
        p.last_ts = time.time()
        self.perf.inc("msgr_msgs_in")
        self.perf.inc("msgr_bytes_in", nbytes)

    def note_wrapped(self, peer: str, nbytes: int, compressed: bool,
                     encrypted: bool) -> None:
        p = self._peer(peer)
        if compressed:
            p.compress_bytes += nbytes
            self.perf.inc("msgr_compress_bytes", nbytes)
        if encrypted:
            p.encrypt_bytes += nbytes
            self.perf.inc("msgr_encrypt_bytes", nbytes)

    def note_reconnect(self, peer: str) -> None:
        p = self._peer(peer)
        p.reconnects += 1
        p.last_ts = time.time()
        self.perf.inc("msgr_reconnects")

    def note_replay(self, peer: str, frames: int) -> None:
        p = self._peer(peer)
        p.replay_frames += frames
        p.last_ts = time.time()
        self.perf.inc("msgr_replay_frames", frames)

    def note_sync_timeout(self) -> None:
        self.sync_timeouts += 1
        self.perf.inc("msgr_sync_timeouts")

    # -- surfaces ------------------------------------------------------------

    def totals(self) -> dict:
        d = self.perf.dump()
        return {
            "msgs_out": d["msgr_msgs_out"],
            "msgs_in": d["msgr_msgs_in"],
            "bytes_out": d["msgr_bytes_out"],
            "bytes_in": d["msgr_bytes_in"],
            "reconnects": d["msgr_reconnects"],
            "replay_frames": d["msgr_replay_frames"],
            "sync_timeouts": d["msgr_sync_timeouts"],
            "compress_bytes": d["msgr_compress_bytes"],
            "encrypt_bytes": d["msgr_encrypt_bytes"],
            "sendq_hwm": self.sendq_hwm,
            "peers": len(self._peers),
        }

    def conn_rows(self) -> list[dict]:
        """Per-peer rows, busiest (bytes out+in) first."""
        with self._lock:
            peers = list(self._peers.values())
        rows = [p.to_dict() for p in peers]
        rows.sort(key=lambda r: -(r["bytes_out"] + r["bytes_in"]))
        return rows

    def set_peer_cap(self, cap: int) -> None:
        self.peer_cap = max(1, int(cap))
        with self._lock:
            while len(self._peers) > self.peer_cap:
                self._peers.popitem(last=False)


class MsgrLedger:
    """Per-process wire-plane ledger (module doc): owns the shared
    reactor/dispatch health state and the registry of per-messenger
    MsgrStats slices."""

    _host: "MsgrLedger | None" = None
    _host_lock = threading.Lock()
    # registered messengers kept (short-lived CLI clients churn; the
    # eviction only drops the LEDGER's reference — the messenger keeps
    # its own stats object working)
    MESSENGER_CAP = 128

    def __init__(self, perf=None, enabled: bool = True,
                 peer_cap: int = 256, probe_interval: float = 0.25,
                 warn_s: float = 1.0, window_s: float = 60.0):
        self.enabled = enabled
        self.peer_cap = max(1, int(peer_cap))
        self.probe_interval = float(probe_interval)
        # monward threshold (conf ms_reactor_lag_warn_s) rides the
        # report so the mon needs no config (the COMPILE_STORM rule)
        self.warn_s = float(warn_s)
        self.window_s = float(window_s)
        self.perf = perf if perf is not None else _build_ledger_perf()
        self._lock = threading.Lock()
        self._messengers: collections.OrderedDict[str, MsgrStats] = \
            collections.OrderedDict()
        # reactor probe state: idx -> (wall ts, last lag); lag events
        # (ts, reactor, lag) in a bounded window deque
        self._reactor_lag: dict[int, tuple[float, float]] = {}
        self._lag_events: collections.deque = \
            collections.deque(maxlen=512)
        self.lag_events_total = 0
        # per-loop probe ownership tokens: re-attaching to a loop (or a
        # recreated pool) replaces the token, so the superseded probe
        # chain dies on its next fire instead of double-counting
        self._probe_tokens: dict[int, object] = {}
        self._dispatch_pending = 0
        self._dispatch_hwm = 0
        self.dispatches_total = 0
        self.created_at = time.time()

    # -- host singleton ------------------------------------------------------

    @classmethod
    def host_instance(cls) -> "MsgrLedger":
        with cls._host_lock:
            if cls._host is None:
                cls._host = cls()
            return cls._host

    @classmethod
    def reset_host(cls) -> None:
        """Tests/benches only: drop the singleton (stats of the old one
        stay readable through any direct references)."""
        with cls._host_lock:
            cls._host = None

    # -- messenger registry --------------------------------------------------

    def register_messenger(self, entity: str,
                           perf=None) -> MsgrStats:
        """A Messenger is born: hand it its ledger slice.  Keyed by
        entity (unique per instance); the registry is bounded."""
        st = MsgrStats(entity, self, perf=perf, peer_cap=self.peer_cap)
        with self._lock:
            self._messengers[entity] = st
            while len(self._messengers) > self.MESSENGER_CAP:
                self._messengers.popitem(last=False)
        return st

    def set_peer_cap(self, cap: int) -> None:
        """conf ms_ledger_peers: applies to registered slices and
        future ones."""
        self.peer_cap = max(1, int(cap))
        with self._lock:
            stats = list(self._messengers.values())
        for st in stats:
            st.set_peer_cap(self.peer_cap)

    # -- dispatch-executor timing (called behind the enabled gate) -----------

    def dispatch_submit(self) -> float:
        """A handler was queued on the shared executor; returns the
        submit stamp the run-side calls thread through."""
        n = self._dispatch_pending + 1
        self._dispatch_pending = n
        self.perf.set("msgr_dispatch_queued", n)
        if n > self._dispatch_hwm:
            self._dispatch_hwm = n
            self.perf.set("msgr_dispatch_queued_hwm", n)
        return time.perf_counter()

    def dispatch_run(self, t_submit: float) -> float:
        """The handler started running: close the queue-wait clock."""
        now = time.perf_counter()
        self.perf.hinc("lat_msgr_qwait", max(0.0, now - t_submit))
        return now

    def dispatch_done(self, t_start: float) -> None:
        self.perf.hinc("lat_msgr_dispatch",
                       max(0.0, time.perf_counter() - t_start))
        self.dispatches_total += 1
        self.perf.inc("msgr_dispatches")
        n = self._dispatch_pending - 1
        self._dispatch_pending = n if n > 0 else 0
        self.perf.set("msgr_dispatch_queued", self._dispatch_pending)

    # -- reactor lag probe ---------------------------------------------------

    def attach_reactors(self, loops, interval: float | None = None
                        ) -> None:
        """Arm the self-rescheduling lag probe on each reactor loop
        (messenger._ensure_pool calls this right after pool creation).
        Probes keep firing while the ledger is disabled — the off-path
        cost is one attribute check per interval — so re-enabling
        needs no re-arm."""
        if interval is not None:
            self.probe_interval = float(interval)
        for idx, loop in enumerate(loops):
            token = object()
            self._probe_tokens[id(loop)] = token
            try:
                loop.call_soon_threadsafe(
                    self._arm_probe, loop, idx, token)
            except RuntimeError:
                pass          # loop already closed (teardown race)

    def _arm_probe(self, loop, idx: int, token) -> None:
        interval = max(0.01, float(self.probe_interval))
        expected = loop.time() + interval
        loop.call_later(interval, self._probe_fire, loop, idx, token,
                        expected, interval)

    def _probe_fire(self, loop, idx: int, token, expected: float,
                    interval: float) -> None:
        if self._probe_tokens.get(id(loop)) is not token:
            return            # superseded (pool recreated / re-attach)
        if self.enabled:
            self.note_reactor_lag(idx, loop.time() - expected,
                                  interval)
        self._arm_probe(loop, idx, token)

    def note_reactor_lag(self, reactor: int, lag: float,
                         interval: float | None = None) -> None:
        """One probe observation.  The histogram/gauge move every
        probe; an EVENT (counter + monward window) only when the probe
        fired a FULL extra interval late — the heartbeat tick-lag
        detector's rule, so a loaded-but-healthy reactor does not
        page."""
        if not self.enabled:
            return
        lag = max(0.0, lag)
        now = time.time()
        self._reactor_lag[reactor] = (now, lag)
        self.perf.hinc("lat_msgr_reactor_lag", lag)
        worst = max((l for _, l in self._reactor_lag.values()),
                    default=0.0)
        self.perf.set("msgr_reactor_lag_worst", worst)
        if interval is None:
            interval = self.probe_interval
        if lag >= interval:
            self.lag_events_total += 1
            self.perf.inc("msgr_reactor_lag_events")
            self._lag_events.append((now, reactor, lag))

    # -- aggregation surfaces ------------------------------------------------

    def _window_events(self) -> list[tuple[float, int, float]]:
        cutoff = time.time() - self.window_s
        return [(ts, r, l) for ts, r, l in list(self._lag_events)
                if ts >= cutoff]

    def pgstats_block(self) -> dict | None:
        """The MPGStats "msgr" block: None unless the lag-event window
        is non-empty, and coarsely rounded, so a healthy daemon's
        report stays bit-identical and the keepalive dedup
        (_pgstats_should_send) keeps working."""
        if not self.enabled:
            return None
        events = self._window_events()
        if not events:
            return None
        worst = max(events, key=lambda e: e[2])
        return {
            "window_s": self.window_s,
            "lag_events": len(events),
            "worst_lag_s": round(worst[2], 2),
            "worst_reactor": worst[1],
            "warn_s": float(self.warn_s),
        }

    def status(self) -> dict:
        """The `messenger status` asok payload."""
        with self._lock:
            msgrs = list(self._messengers.items())
        return {
            "enabled": self.enabled,
            "uptime_s": round(time.time() - self.created_at, 3),
            "reactors": {
                "count": len(self._reactor_lag),
                "probe_interval_s": self.probe_interval,
                "last_lag_s": {str(i): round(lag, 6)
                               for i, (_ts, lag)
                               in sorted(self._reactor_lag.items())},
                "lag_events": self.lag_events_total,
            },
            "dispatch": {
                "pending": self._dispatch_pending,
                "hwm": self._dispatch_hwm,
                "total": self.dispatches_total,
            },
            "latencies": self.perf.dump_latencies(),
            "messengers": {name: st.totals() for name, st in msgrs},
            "window": self.pgstats_block(),
        }

    def conn_profile(self, last: int | None = None) -> dict:
        """The `conn profile` asok payload: per-peer rows per
        messenger, busiest first (`last` caps rows per messenger)."""
        with self._lock:
            msgrs = list(self._messengers.items())
        out = {}
        for name, st in msgrs:
            rows = st.conn_rows()
            if last is not None:
                rows = rows[:max(0, int(last))]
            out[name] = rows
        return {"enabled": self.enabled, "messengers": out}

    def bench_summary(self) -> dict:
        """The bench-row provenance block (`msgr_ledger` in
        cluster_bench --scale rows, beside recovery_blame): reactor
        lag + dispatch percentiles, wire totals, top peers."""
        def q(key, quant):
            est = self.perf.quantile(key, quant)
            return round(est[0] * 1e3, 3) if est else None
        with self._lock:
            msgrs = list(self._messengers.values())
        totals = {"msgs_out": 0, "msgs_in": 0, "bytes_out": 0,
                  "bytes_in": 0, "reconnects": 0, "replay_frames": 0,
                  "sync_timeouts": 0}
        peer_bytes: dict[str, int] = {}
        for st in msgrs:
            t = st.totals()
            for k in totals:
                totals[k] += t[k]
            for row in st.conn_rows():
                peer_bytes[row["peer"]] = \
                    peer_bytes.get(row["peer"], 0) + \
                    row["bytes_out"] + row["bytes_in"]
        top_peers = dict(sorted(peer_bytes.items(),
                                key=lambda kv: -kv[1])[:8])
        out = {
            "reactor_lag_ms_p50": q("lat_msgr_reactor_lag", 0.5),
            "reactor_lag_ms_p99": q("lat_msgr_reactor_lag", 0.99),
            "qwait_ms_p50": q("lat_msgr_qwait", 0.5),
            "qwait_ms_p99": q("lat_msgr_qwait", 0.99),
            "dispatch_ms_p50": q("lat_msgr_dispatch", 0.5),
            "dispatch_ms_p99": q("lat_msgr_dispatch", 0.99),
            "lag_events": self.lag_events_total,
            "dispatch_hwm": self._dispatch_hwm,
            "dispatches": self.dispatches_total,
            "peer_bytes": top_peers,
        }
        out.update(totals)
        return out

    def reset(self) -> None:
        """Clear window/table state (benches isolating a phase; the
        perf histograms are monotonic by design and stay)."""
        with self._lock:
            self._messengers.clear()
        self._reactor_lag.clear()
        self._lag_events.clear()
        self.lag_events_total = 0
        self._dispatch_pending = 0
        self._dispatch_hwm = 0
        self.dispatches_total = 0
        self.created_at = time.time()


def msgr_ledger() -> MsgrLedger:
    """The process's wire-plane recorder (built on first use,
    enabled); the common fast path skips the singleton lock."""
    led = MsgrLedger._host
    return led if led is not None else MsgrLedger.host_instance()

"""Device-plane flight recorder: launch ledger + build attribution.

The port of ceph_tpu/ops/profiler.py.  Every device launch the launch
queue (parallel/launch_queue.py) or the ECBackend's direct path issues
— fused encode, plain encode, recovery decode, CLAY repair — gets a
monotonic launch id and a `LaunchRecord`: kind, codec label, launch
bucket, runs, input bytes, queue wait, submit wall time,
submit->materialize device time and PG mix.  Completed records live in
a bounded ring (`profile()`), and `lat_launch_submit` /
`lat_launch_device` / `lat_launch_queue_wait` histograms share
DEFAULT_LAT_BUCKETS with the rest of the perf counters.

Compile attribution, translated: on the TPU the first launch of a jit
bucket (a distinct kind, path and padded shape) paid an XLA/Mosaic
compile, and the reference's ledger times it, with its persistent
compile cache marking disk-served compiles.  On the card nothing
compiles per shape: the kernels are one nvcc-built library
(ops/_build.py), built once per source hash into the directory
ops/compile_cache.py names, or loaded from it.  So a first-seen bucket
here counts as `compiled` only when its submit ran an nvcc build in this
process (`_build.build_count()` moved), and as a `cache_hit` otherwise
(the library was already built or loaded); its first-launch seconds
still carry the card's other first-use costs (the CUDA context, each
kernel's lazy module load, pinned staging), which the ledger shows as
first_s against steady_s.  A compile over `stall_s` counts in
`ec_compile_stalls` and enters the window `compile_report()` sums.
`inject_stall_s` (conf osd_ec_inject_compile_stall) sleeps in the
submit of each first-seen bucket and counts it as a build, as the
reference's does.

The boot prewarm (ops/prewarm.py) seeds the buckets it ran through
`note_prewarm`, so their first runtime launch is not first-seen;
`prewarm_summary()` is its tally, `bench_summary()` a run's provenance
block (torch, CUDA and the card's name where the reference reported
jax and its device), `set_ring_size` the startup ring resize.

Always on, null when off: disabled, `begin()` returns None after one
attribute check and every other entry point no-ops on a None record.

The rest of the port's launch tracing lives beside the kernel wrappers
in ops/bitsliced.py: `launch_counts()` counts every launch by wrapper,
and `launch_stages()` splits the host time of the launches made while
a torch.profiler session records into `prep` (the entry's first line
to just before the C call) and `launch` (the C call up to its return
code), each also a span, `ec.prep` and `ec.launch`, on the trace's
clock.  Outside a profiler session an entry reads one flag for them.
The OSD's `launch profile` reports both beside this recorder's ledger.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

from . import _build, compile_cache


def _build_prof_perf(name: str = "device_profiler"):
    from ..common.perf_counters import PerfCountersBuilder
    return (PerfCountersBuilder(name)
            .add_u64_counter("ec_launches",
                             "device launches recorded in the ledger")
            .add_u64_counter("ec_launch_runs",
                             "runs carried by recorded launches")
            .add_u64_counter("ec_launch_bytes",
                             "input bytes carried by recorded launches")
            .add_u64_counter("ec_compile_stalls",
                             "first-seen launch buckets whose submit ran "
                             "an nvcc build longer than stall_s")
            .add_u64_counter("ec_compile_cache_hits",
                             "first-seen launch buckets served by an "
                             "already built kernel library")
            .add_u64_counter("ec_prewarm_compiles",
                             "buckets the boot prewarm ran while "
                             "building the kernel library")
            .add_u64_counter("ec_prewarm_cache_hits",
                             "buckets the boot prewarm ran on an "
                             "already built kernel library")
            .add_histogram("lat_launch_submit",
                           "launch dispatch wall time (includes the "
                           "kernel build on the first launch)")
            .add_histogram("lat_launch_device",
                           "submit -> materialize device time")
            .add_histogram("lat_launch_queue_wait",
                           "host-queue batching wait before launch")
            .add_histogram("lat_prewarm",
                           "per-bucket boot-time prewarm wall")
            .create_perf_counters())


class LaunchRecord:
    """One device launch's ledger entry (the ring's payload), with the
    trace ids of the tracked ops it served in `traces`."""

    __slots__ = ("launch_id", "kind", "codec", "bucket", "path",
                 "runs", "nbytes", "pg_mix", "traces", "queue_wait_s",
                 "submit_s", "device_s", "compiled", "compile_s",
                 "cache_hit", "ts", "_t0", "_builds0")

    def __init__(self, launch_id: int, kind: str, codec: str,
                 runs: int, nbytes: int, pg_mix: int, traces,
                 queue_wait_s: float):
        self.launch_id = launch_id
        self.kind = kind
        self.codec = codec
        self.bucket: str | None = None
        self.path: str | None = None
        self.runs = runs
        self.nbytes = nbytes
        self.pg_mix = pg_mix
        # the contributing ops' trace ids, bounded: a super-batch of
        # many ops keeps the first few
        self.traces = tuple(traces)[:8]
        self.queue_wait_s = queue_wait_s
        self.submit_s = 0.0
        self.device_s = 0.0
        self.compiled = False
        self.compile_s = 0.0
        # a FIRST launch of this bucket that found the kernel library
        # already built: fast by construction, never a stall
        self.cache_hit = False
        self.ts = time.time()
        self._t0 = time.perf_counter()
        # nvcc builds at record start: submitted() deltas it to
        # attribute an in-process build to THIS launch
        self._builds0 = _build.build_count()

    def to_dict(self) -> dict:
        return {
            "launch_id": self.launch_id,
            "kind": self.kind,
            "codec": self.codec,
            "bucket": self.bucket,
            "path": self.path,
            "runs": self.runs,
            "bytes": self.nbytes,
            "pg_mix": self.pg_mix,
            "traces": list(self.traces),
            "queue_wait_ms": round(self.queue_wait_s * 1e3, 3),
            "submit_ms": round(self.submit_s * 1e3, 3),
            "device_ms": round(self.device_s * 1e3, 3),
            "compiled": self.compiled,
            "compile_s": round(self.compile_s, 4),
            "cache_hit": self.cache_hit,
            "ts": self.ts,
        }


class DeviceProfiler:
    """Per-host (process-wide, like ECLaunchQueue) launch ledger +
    build ledger."""

    _host: "DeviceProfiler | None" = None
    _host_lock = threading.Lock()

    def __init__(self, ring_size: int = 256, stall_s: float = 0.25,
                 storm_window_s: float = 60.0, perf=None,
                 enabled: bool = True):
        self.enabled = enabled
        self.stall_s = float(stall_s)
        self.storm_window_s = float(storm_window_s)
        # fault injection (conf osd_ec_inject_compile_stall): sleep
        # inside the submit of every first-seen bucket, which then
        # counts as a build — the shape of a real build stall, for the
        # storm and health checks
        self.inject_stall_s = 0.0
        self.perf = perf if perf is not None else _build_prof_perf()
        self._lock = threading.Lock()
        self._next_id = 1
        self._ring: collections.deque[LaunchRecord] = \
            collections.deque(maxlen=max(1, int(ring_size)))
        # bucket key -> {count, first_s, steady_min_s, first_ts}
        self._buckets: dict[str, dict] = {}
        # recent in-process builds (ts, bucket, seconds): the window
        # compile_report sums; bounded, and steady state adds none
        self._compile_events: collections.deque = \
            collections.deque(maxlen=512)
        # materialized launches by kind, unbounded by the ring
        self._by_kind: collections.Counter = collections.Counter()
        self.launches = 0
        self.launched_runs = 0
        self.launched_bytes = 0
        self.compile_stalls = 0
        self.cache_hits = 0
        # boot prewarm tallies (ops/prewarm.py feeds them through
        # note_prewarm)
        self.prewarm_compiles = 0
        self.prewarm_cache_hits = 0
        self.prewarm_s = 0.0
        self.created_at = time.time()

    # -- host singleton ------------------------------------------------------

    @classmethod
    def host_instance(cls) -> "DeviceProfiler":
        with cls._host_lock:
            if cls._host is None:
                cls._host = cls()
            return cls._host

    @classmethod
    def reset_host(cls) -> None:
        """Tests/benches only: drop the singleton (records of the old
        one stay readable through any direct references)."""
        with cls._host_lock:
            cls._host = None

    def set_ring_size(self, n: int) -> None:
        """Resize the completed-launch ring (startup conf
        osd_ec_profiler_ring; existing records carry over, oldest
        dropped)."""
        with self._lock:
            self._ring = collections.deque(self._ring,
                                           maxlen=max(1, int(n)))

    # -- recording -----------------------------------------------------------

    def begin(self, kind: str, codec: str = "", runs: int = 1,
              nbytes: int = 0, pg_mix: int = 1, traces=(),
              queue_wait_s: float = 0.0) -> LaunchRecord | None:
        """Start a launch record (call IMMEDIATELY before the device
        submit — the record's t0 anchors the submit wall clock).
        Returns None when profiling is off."""
        if not self.enabled:
            return None
        with self._lock:
            lid = self._next_id
            self._next_id += 1
        return LaunchRecord(lid, kind, codec, runs, nbytes, pg_mix,
                            traces, queue_wait_s)

    def submitted(self, rec: LaunchRecord | None, bucket: str,
                  path: str | None = None, jit: bool = True) -> None:
        """The device submit returned: close the submit clock, detect a
        first-seen launch bucket and attribute an in-process kernel
        build to it.  No-op on a None record.

        jit=False marks a host-synchronous launch with no kernel behind
        it (a CPU plugin's encode or decode): its submit wall lands in
        the histograms and the ring, never in the build ledger."""
        if rec is None:
            return
        if jit and self.inject_stall_s > 0:
            with self._lock:
                first = bucket not in self._buckets
            if first:
                time.sleep(self.inject_stall_s)
        else:
            first = False
        rec.submit_s = time.perf_counter() - rec._t0
        rec.bucket = bucket
        rec.path = path
        if jit:
            # an armed injection is a build, whatever the library did
            built = first or _build.build_count() > rec._builds0
            stalled = hit = False
            with self._lock:
                ent = self._buckets.get(bucket)
                if ent is None:
                    self._buckets[bucket] = {
                        "count": 1, "first_s": rec.submit_s,
                        "steady_min_s": None, "first_ts": rec.ts,
                        "cache_hit": not built}
                    rec.compiled = built
                    rec.compile_s = rec.submit_s if built else 0.0
                    rec.cache_hit = not built
                    if built:
                        self._compile_events.append(
                            (time.time(), bucket, rec.submit_s))
                    if built and rec.submit_s >= self.stall_s:
                        self.compile_stalls += 1
                        stalled = True
                    elif not built:
                        self.cache_hits += 1
                        hit = True
                else:
                    ent["count"] += 1
                    if ent.get("prewarmed") and ent["count"] == 1:
                        # first runtime launch of a boot-prewarmed
                        # bucket: a cache hit, not a first launch
                        rec.cache_hit = True
                    sm = ent["steady_min_s"]
                    ent["steady_min_s"] = rec.submit_s if sm is None \
                        else min(sm, rec.submit_s)
            if self.perf:
                if stalled:
                    self.perf.inc("ec_compile_stalls")
                if hit:
                    self.perf.inc("ec_compile_cache_hits")
        if self.perf:
            self.perf.hinc("lat_launch_submit", rec.submit_s)
            self.perf.hinc("lat_launch_queue_wait", rec.queue_wait_s)

    def materialized(self, rec: LaunchRecord | None,
                     device_s: float) -> None:
        """The launch's results materialized: close the record into
        the ring.  No-op on a None record."""
        if rec is None:
            return
        rec.device_s = device_s
        with self._lock:
            self._ring.append(rec)
            self._by_kind[rec.kind] += 1
            self.launches += 1
            self.launched_runs += rec.runs
            self.launched_bytes += rec.nbytes
        if self.perf:
            self.perf.inc("ec_launches")
            self.perf.inc("ec_launch_runs", rec.runs)
            self.perf.inc("ec_launch_bytes", rec.nbytes)
            self.perf.hinc("lat_launch_device", device_s)

    def note_prewarm(self, bucket: str, warm_s: float,
                     cache_hit: bool) -> None:
        """Record one boot-time prewarm entry's bucket (ops/prewarm.py):
        it enters the ledger pre-seeded, so its first runtime launch is
        not first-seen.  Prewarm builds never enter the compile_report
        window: they happen before the daemon reports up."""
        with self._lock:
            if bucket not in self._buckets:
                self._buckets[bucket] = {
                    "count": 0, "first_s": warm_s,
                    "steady_min_s": None, "first_ts": time.time(),
                    "prewarmed": True, "cache_hit": cache_hit}
            if cache_hit:
                self.prewarm_cache_hits += 1
            else:
                self.prewarm_compiles += 1
            self.prewarm_s += warm_s
        if self.perf:
            self.perf.inc("ec_prewarm_cache_hits" if cache_hit
                          else "ec_prewarm_compiles")
            self.perf.hinc("lat_prewarm", warm_s)

    def prewarm_summary(self) -> dict:
        """The prewarm tallies block (`prewarm status` / the compile
        ledger)."""
        with self._lock:
            prewarmed = sum(1 for e in self._buckets.values()
                            if e.get("prewarmed"))
            return {
                "compiles": self.prewarm_compiles,
                "cache_hits": self.prewarm_cache_hits,
                "buckets": prewarmed,
                "total_s": round(self.prewarm_s, 3),
            }

    # -- build ledger --------------------------------------------------------

    def _bucket_rows(self) -> list[dict]:
        with self._lock:
            items = [(b, dict(e)) for b, e in self._buckets.items()]
        rows = []
        for bucket, e in items:
            steady = e["steady_min_s"]
            compile_s = 0.0 if e["cache_hit"] else (
                e["first_s"] if steady is None
                else max(0.0, e["first_s"] - steady))
            rows.append({
                "bucket": bucket,
                "count": e["count"],
                "first_s": round(e["first_s"], 4),
                "steady_s": round(steady, 6)
                if steady is not None else None,
                "compile_s": round(compile_s, 4),
                "first_ts": e["first_ts"],
                "prewarmed": bool(e.get("prewarmed")),
                "cache_hit": bool(e["cache_hit"]),
            })
        rows.sort(key=lambda r: -r["compile_s"])
        return rows

    def compile_ledger(self) -> dict:
        """Every launch bucket this host has seen, worst build first,
        with the kernel library's provenance."""
        rows = self._bucket_rows()
        return {
            "enabled": self.enabled,
            "stall_threshold_s": self.stall_s,
            "buckets": rows,
            "distinct_buckets": len(rows),
            "total_compile_s": round(
                sum(r["compile_s"] for r in rows), 4),
            "max_compile_s": round(
                max((r["compile_s"] for r in rows), default=0.0), 4),
            "compile_stalls": self.compile_stalls,
            "compile_cache_hits": self.cache_hits,
            "kernel_library": _build.status(),
            "prewarm": self.prewarm_summary(),
            "persistent_cache": compile_cache.status(),
            "window": self.compile_report(),
        }

    def compile_report(self, window_s: float | None = None) -> dict:
        """Windowed build summary (what the reference's OSD ships to the
        monitor for its COMPILE_STORM warning)."""
        window_s = self.storm_window_s if window_s is None \
            else float(window_s)
        cutoff = time.time() - window_s
        with self._lock:
            recent = [(b, s) for ts, b, s in self._compile_events
                      if ts >= cutoff]
        total = sum(s for _b, s in recent)
        worst = max(recent, key=lambda e: e[1], default=None)
        return {
            "window_s": window_s,
            "compile_s": round(total, 3),
            "events": len(recent),
            "stalls": sum(1 for _b, s in recent if s >= self.stall_s),
            "stalls_total": self.compile_stalls,
            "worst_bucket": worst[0] if worst else None,
            "worst_s": round(worst[1], 3) if worst else 0.0,
        }

    # -- dumps ---------------------------------------------------------------

    def profile(self, last: int | None = None) -> dict:
        """Ledger aggregates, the materialized launches by kind
        ("fused_encode", "plain_encode", "decode", "clay_repair") since
        the last reset, and the (bounded) ring of recent launches,
        newest last."""
        with self._lock:
            ring = list(self._ring)
            launches = self.launches
            by_kind = dict(self._by_kind)
        if last is not None:
            n = max(0, int(last))
            ring = ring[-n:] if n else []
        lat = self.perf.dump_latencies() if self.perf else {}
        return {
            "enabled": self.enabled,
            "launches": launches,
            "by_kind": by_kind,
            "runs": self.launched_runs,
            "bytes": self.launched_bytes,
            "runs_per_launch": round(self.launched_runs / launches, 2)
            if launches else 0.0,
            "ring_size": self._ring.maxlen,
            "latencies": lat,
            "recent": [r.to_dict() for r in ring],
            "uptime_s": round(time.time() - self.created_at, 1),
        }

    def bench_summary(self) -> dict:
        """A run's provenance block: enough for a reader of its numbers
        to see what the device plane did, and on which torch, CUDA and
        card."""
        def q(key, quant):
            est = self.perf.quantile(key, quant) if self.perf else None
            return round(est[0] * 1e3, 3) if est else None
        with self._lock:
            launches = self.launches
        rows = self._bucket_rows()
        out = {
            "launches": launches,
            "runs_per_launch": round(self.launched_runs / launches, 2)
            if launches else 0.0,
            "bytes": self.launched_bytes,
            "compile_buckets": len(rows),
            "compile_s_total": round(
                sum(r["compile_s"] for r in rows), 3),
            "compile_stalls": self.compile_stalls,
            "compile_cache_hits": self.cache_hits,
            "prewarm_compiles": self.prewarm_compiles,
            "prewarm_cache_hits": self.prewarm_cache_hits,
            "device_ms_p50": q("lat_launch_device", 0.5),
            "device_ms_p99": q("lat_launch_device", 0.99),
            "queue_wait_ms_p50": q("lat_launch_queue_wait", 0.5),
            "queue_wait_ms_p99": q("lat_launch_queue_wait", 0.99),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
        if torch.cuda.is_available():
            out["device_kind"] = torch.cuda.get_device_name(0)
        return out

    def reset(self) -> None:
        """Clear ledger state (benches isolating a phase; the perf
        histograms are monotonic by design and stay)."""
        with self._lock:
            self._ring.clear()
            self._buckets.clear()
            self._compile_events.clear()
            self._by_kind.clear()
            self.launches = 0
            self.launched_runs = 0
            self.launched_bytes = 0
            self.compile_stalls = 0
            self.cache_hits = 0
            self.prewarm_compiles = 0
            self.prewarm_cache_hits = 0
            self.prewarm_s = 0.0


def device_profiler() -> DeviceProfiler:
    """The host's flight recorder (built on first use, enabled)."""
    return DeviceProfiler.host_instance()

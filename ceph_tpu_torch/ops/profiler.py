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
compile cache (ops/compile_cache.py) marking disk-served compiles.  On
the card nothing compiles per shape: the kernels are one nvcc-built
library (ops/_build.py), built once per source hash into the build
directory, or loaded from it.  So a first-seen bucket here counts as
`compiled` only when its submit ran an nvcc build in this process
(`_build.build_count()` moved), and as a `cache_hit` otherwise (the
library was already built or loaded); `compile_ledger()` carries
`_build.status()` where the reference carried its cache's.  A compile
over `stall_s` counts in `ec_compile_stalls`.  Not ported yet, with the
consumers that read them (the OSD's asok, bench rows, the monitor's
COMPILE_STORM window): the boot prewarm's tallies, the windowed compile
report, bench_summary and the ring resize.

Always on, null when off: disabled, `begin()` returns None after one
attribute check and every other entry point no-ops on a None record.
"""

from __future__ import annotations

import collections
import threading
import time

from . import _build


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
            .add_histogram("lat_launch_submit",
                           "launch dispatch wall time (includes the "
                           "kernel build on the first launch)")
            .add_histogram("lat_launch_device",
                           "submit -> materialize device time")
            .add_histogram("lat_launch_queue_wait",
                           "host-queue batching wait before launch")
            .create_perf_counters())


class LaunchRecord:
    """One device launch's ledger entry (the ring's payload; the
    reference's op-trace ids come with tracked ops, not ported yet)."""

    __slots__ = ("launch_id", "kind", "codec", "bucket", "path",
                 "runs", "nbytes", "pg_mix", "queue_wait_s",
                 "submit_s", "device_s", "compiled", "compile_s",
                 "cache_hit", "ts", "_t0", "_builds0")

    def __init__(self, launch_id: int, kind: str, codec: str,
                 runs: int, nbytes: int, pg_mix: int,
                 queue_wait_s: float):
        self.launch_id = launch_id
        self.kind = kind
        self.codec = codec
        self.bucket: str | None = None
        self.path: str | None = None
        self.runs = runs
        self.nbytes = nbytes
        self.pg_mix = pg_mix
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
                 perf=None, enabled: bool = True):
        self.enabled = enabled
        self.stall_s = float(stall_s)
        self.perf = perf if perf is not None else _build_prof_perf()
        self._lock = threading.Lock()
        self._next_id = 1
        self._ring: collections.deque[LaunchRecord] = \
            collections.deque(maxlen=max(1, int(ring_size)))
        # bucket key -> {count, first_s, steady_min_s, first_ts}
        self._buckets: dict[str, dict] = {}
        # materialized launches by kind, unbounded by the ring
        self._by_kind: collections.Counter = collections.Counter()
        self.launches = 0
        self.launched_runs = 0
        self.launched_bytes = 0
        self.compile_stalls = 0
        self.cache_hits = 0
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

    # -- recording -----------------------------------------------------------

    def begin(self, kind: str, codec: str = "", runs: int = 1,
              nbytes: int = 0, pg_mix: int = 1,
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
                            queue_wait_s)

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
        rec.submit_s = time.perf_counter() - rec._t0
        rec.bucket = bucket
        rec.path = path
        if jit:
            built = _build.build_count() > rec._builds0
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
                    if built and rec.submit_s >= self.stall_s:
                        self.compile_stalls += 1
                        stalled = True
                    elif not built:
                        self.cache_hits += 1
                        hit = True
                else:
                    ent["count"] += 1
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

    def reset(self) -> None:
        """Clear ledger state (benches isolating a phase; the perf
        histograms are monotonic by design and stay)."""
        with self._lock:
            self._ring.clear()
            self._buckets.clear()
            self._by_kind.clear()
            self.launches = 0
            self.launched_runs = 0
            self.launched_bytes = 0
            self.compile_stalls = 0
            self.cache_hits = 0


def device_profiler() -> DeviceProfiler:
    """The host's flight recorder (built on first use, enabled)."""
    return DeviceProfiler.host_instance()

"""Per-daemon performance counters.

Re-expresses the reference's PerfCounters (src/common/perf_counters.h):
typed counters built once per component (counter / gauge / time /
long-running-average), updated lock-free on the hot path (here: plain
int/float updates under the GIL, with a lock only for dump), dumped via
the admin socket (`perf dump`) and shipped to the mgr role.

The port's copy of ceph_tpu/common/perf_counters.py (standard library
only): the counter sets of the ECBackend, the launch queue and the
flight recorder.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from enum import Enum


class CounterType(Enum):
    U64 = "u64"              # monotonically increasing counter
    GAUGE = "gauge"          # settable level
    TIME = "time"            # accumulated seconds
    AVG = "avg"              # (sum, count) long-running average
    HISTOGRAM = "hist"       # bucketed samples (prometheus histogram)


# The percentile set every latency surface publishes (dump_latencies
# asok, the exporter's precomputed gauges, the load harness rows):
# production tails are ruled by p99/p999, p50/p95 anchor the body.
LATENCY_QUANTILES = ((0.5, "p50"), (0.95, "p95"),
                     (0.99, "p99"), (0.999, "p999"))


def quantile_from_cumulative(buckets: list, q: float
                             ) -> tuple[float, float, float] | None:
    """Quantile estimate from prometheus-style cumulative buckets
    [[le, cum], ..., ["+Inf", total]] — the exact shape PerfCounters
    histograms dump and the exporter scrapes.

    Returns (estimate, err_lo, err_hi) or None for an empty histogram.
    The estimate linearly interpolates inside the bucket holding the
    q-th sample (the classic histogram_quantile estimator); err_lo/
    err_hi are the bucket bounds — the true quantile provably lies in
    [err_lo, err_hi], so the publication carries its own error bar.
    A quantile landing in the +Inf bucket reports the last finite
    bound as the estimate with err_hi = inf (the honest answer: the
    axis ran out, widen the buckets)."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    rank = q * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in buckets:
        if le == "+Inf":
            if cum > prev_cum and rank > prev_cum:
                return (prev_le, prev_le, float("inf"))
            # rank landed exactly on the finite edge
            return (prev_le, prev_le, prev_le)
        if cum >= rank:
            lo = prev_le
            frac = ((rank - prev_cum) / (cum - prev_cum)) \
                if cum > prev_cum else 1.0
            return (lo + frac * (le - lo), lo, le)
        prev_le, prev_cum = le, cum
    return (prev_le, prev_le, float("inf"))


def percentiles_from_samples(samples: list, quantiles=None) -> dict:
    """Exact percentiles from raw latency samples (the harness's
    per-op recordings; nearest-rank on the sorted list).  Returns
    {label: seconds} for LATENCY_QUANTILES (or the given
    [(q, label), ...]); empty dict when there are no samples."""
    if not samples:
        return {}
    import math
    s = sorted(samples)
    out = {}
    for q, label in (quantiles or LATENCY_QUANTILES):
        # nearest-rank: the ceil(q*n)-th order statistic (1-indexed)
        idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
        out[label] = s[idx]
    return out


# Log-spaced latency bounds in seconds (reference PerfHistogram axis
# config; prometheus-style, the implicit +Inf bucket holds the rest).
DEFAULT_LAT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Control-plane axis (peering rounds, recovery passes, mon dispatch
# under churn): the device-plane buckets top out at 10 s, but a
# 128-OSD re-peer or a wide backfill scan legitimately runs minutes —
# a lat_peering_* histogram on the default axis would park every
# interesting sample in +Inf and the p99 would read "10 s, probably".
CONTROL_LAT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)


@dataclass
class _Counter:
    name: str
    type: CounterType
    desc: str = ""
    value: float = 0
    sum: float = 0
    count: int = 0
    buckets: tuple = ()           # histogram upper bounds
    hist: list = field(default_factory=list)  # per-bucket counts (+Inf last)


class PerfCountersBuilder:
    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, _Counter] = {}

    def add_u64_counter(self, key: str, desc: str = ""):
        self._counters[key] = _Counter(key, CounterType.U64, desc)
        return self

    def add_gauge(self, key: str, desc: str = ""):
        self._counters[key] = _Counter(key, CounterType.GAUGE, desc)
        return self

    def add_time_avg(self, key: str, desc: str = ""):
        self._counters[key] = _Counter(key, CounterType.AVG, desc)
        return self

    def add_histogram(self, key: str, desc: str = "",
                      buckets: tuple = DEFAULT_LAT_BUCKETS):
        c = _Counter(key, CounterType.HISTOGRAM, desc,
                     buckets=tuple(buckets))
        c.hist = [0] * (len(c.buckets) + 1)
        self._counters[key] = c
        return self

    def create_perf_counters(self) -> "PerfCounters":
        return PerfCounters(self.name, self._counters)


class PerfCounters:
    def __init__(self, name: str, counters: dict[str, _Counter]):
        self.name = name
        self._c = counters
        self._lock = threading.Lock()

    def inc(self, key: str, by: float = 1) -> None:
        self._c[key].value += by

    def dinc(self, key: str, by: float = 1) -> None:
        """inc() for dynamic key sets (the mClock per-class counters:
        op classes appear at runtime as tenants do): creates the U64
        counter on first use, like hinc does for histograms."""
        c = self._c.get(key)
        if c is None:
            with self._lock:
                c = self._c.get(key)
                if c is None:
                    c = _Counter(key, CounterType.U64)
                    self._c[key] = c
        c.value += by

    def set(self, key: str, value: float) -> None:
        self._c[key].value = value

    def tinc(self, key: str, seconds: float) -> None:
        c = self._c[key]
        c.sum += seconds
        c.count += 1

    def hinc(self, key: str, value: float) -> None:
        """Observe one sample into a histogram counter.  Creates the
        histogram on first use — consumers with dynamic key sets (the
        OpTracker's per-stage latency series) need not predeclare."""
        c = self._c.get(key)
        if c is None:
            with self._lock:
                c = self._c.get(key)
                if c is None:
                    c = _Counter(key, CounterType.HISTOGRAM,
                                 buckets=DEFAULT_LAT_BUCKETS)
                    c.hist = [0] * (len(c.buckets) + 1)
                    self._c[key] = c
        c.hist[bisect.bisect_left(c.buckets, value)] += 1
        c.sum += value
        c.count += 1

    def time(self, key: str):
        """Context manager timing a block into a time-avg counter."""
        pc = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                pc.tinc(key, time.perf_counter() - self.t0)
        return _T()

    def dump(self) -> dict:
        with self._lock:
            out = {}
            for key, c in self._c.items():
                if c.type == CounterType.AVG:
                    out[key] = {"avgcount": c.count, "sum": c.sum,
                                "avgtime": c.sum / c.count if c.count else 0}
                elif c.type == CounterType.HISTOGRAM:
                    # cumulative prometheus-style buckets, +Inf last
                    out[key] = {"sum": c.sum, "count": c.count,
                                "buckets": self._cumulative(c)}
                else:
                    out[key] = c.value
            return out

    def schema(self) -> dict:
        """key -> counter type name (reference `perf schema`): lets the
        prometheus exporter emit correct # TYPE lines instead of
        untyped."""
        return {key: c.type.value for key, c in self._c.items()}

    # -- percentile pipeline (tail-latency observability) --------------------

    def _cumulative(self, c: _Counter) -> list:
        cum, buckets = 0, []
        for le, n in zip(c.buckets, c.hist):
            cum += n
            buckets.append([le, cum])
        buckets.append(["+Inf", cum + c.hist[-1]])
        return buckets

    def quantile(self, key: str, q: float
                 ) -> tuple[float, float, float] | None:
        """(estimate, err_lo, err_hi) of a histogram counter's q-th
        quantile, or None when the key is absent/empty/not a
        histogram (see quantile_from_cumulative)."""
        c = self._c.get(key)
        if c is None or c.type != CounterType.HISTOGRAM:
            return None
        with self._lock:
            buckets = self._cumulative(c)
        return quantile_from_cumulative(buckets, q)

    def dump_latencies(self) -> dict:
        """Precomputed percentile summary of every histogram counter:
        {key: {count, sum, p50, p95, p99, p999, p99_err: [lo, hi]}} —
        the `dump_latencies` asok payload and the exporter's gauge
        source.  Estimates are bucket-interpolated; p99_err carries
        the p99's bucket bounds so consumers see the resolution."""
        with self._lock:
            snap = [(key, c.count, c.sum, self._cumulative(c))
                    for key, c in self._c.items()
                    if c.type == CounterType.HISTOGRAM]
        out = {}
        for key, count, total, buckets in snap:
            row = {"count": count, "sum": round(total, 9)}
            for q, label in LATENCY_QUANTILES:
                est = quantile_from_cumulative(buckets, q)
                row[label] = round(est[0], 9) if est else None
                if est and label == "p99":
                    row["p99_err"] = [round(est[1], 9),
                                      est[2] if est[2] == float("inf")
                                      else round(est[2], 9)]
            out[key] = row
        return out


class PerfCountersCollection:
    """All counter sets of one daemon (reference PerfCountersCollection),
    the object `perf dump` walks."""

    def __init__(self) -> None:
        self._sets: dict[str, PerfCounters] = {}
        self._lock = threading.Lock()

    def add(self, pc: PerfCounters) -> PerfCounters:
        with self._lock:
            self._sets[pc.name] = pc
        return pc

    def dump(self) -> dict:
        with self._lock:
            return {name: pc.dump() for name, pc in self._sets.items()}

    def schema(self) -> dict:
        with self._lock:
            return {name: pc.schema() for name, pc in self._sets.items()}

    def dump_latencies(self) -> dict:
        """Percentile summaries of every set's histogram counters
        (the daemon-wide `dump_latencies` asok command); sets without
        histograms are omitted."""
        with self._lock:
            sets = list(self._sets.items())
        out = {}
        for name, pc in sets:
            lat = pc.dump_latencies()
            if lat:
                out[name] = lat
        return out

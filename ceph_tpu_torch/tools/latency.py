"""Per-op latency recording + workload shaping for the load tools.

The pieces `cluster_bench.py` (throughput rows) and `load_harness.py`
(tail-latency rows) share: a thread-safe per-op latency/error recorder
whose JSON summary carries exact percentiles, a Zipf hot-object
sampler, and burst arrival schedules (reference `rados bench` records
per-op latencies the same way; Zipf + bursts are the standard shape of
production object traffic).
"""

from __future__ import annotations

import threading

import numpy as np

from ..common.perf_counters import percentiles_from_samples


class LatencyRecorder:
    """Per-op end-to-end latency samples + errors bucketed by exception
    type.  record()/error() are one lock + one append — cheap enough
    for every op of a load run; summary() reports exact (nearest-rank)
    percentiles over the raw samples, not bucket estimates."""

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._samples: list[float] = []
        self._errors: dict[str, int] = {}

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)

    def error(self, exc: BaseException) -> None:
        key = type(exc).__name__
        with self._lock:
            self._errors[key] = self._errors.get(key, 0) + 1

    def merge(self, other: "LatencyRecorder") -> None:
        with other._lock:
            samples = list(other._samples)
            errors = dict(other._errors)
        with self._lock:
            self._samples.extend(samples)
            for k, v in errors.items():
                self._errors[k] = self._errors.get(k, 0) + v

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._samples)

    @property
    def error_count(self) -> int:
        with self._lock:
            return sum(self._errors.values())

    def samples(self) -> list[float]:
        with self._lock:
            return list(self._samples)

    def summary(self, unit_ms: bool = True) -> dict:
        """{ops, errors, errors_by_type, p50/p95/p99/p999[, mean, max]}
        — the JSON-row payload.  unit_ms publishes milliseconds (the
        readable unit for op latency); percentiles are exact over the
        recorded samples."""
        with self._lock:
            samples = list(self._samples)
            errors = dict(self._errors)
        scale = 1e3 if unit_ms else 1.0
        suffix = "_ms" if unit_ms else "_s"
        out = {"ops": len(samples),
               "errors": sum(errors.values()),
               "errors_by_type": errors}
        if samples:
            for label, v in percentiles_from_samples(samples).items():
                out[f"{label}{suffix}"] = round(v * scale, 4)
            out[f"mean{suffix}"] = round(
                sum(samples) / len(samples) * scale, 4)
            out[f"max{suffix}"] = round(max(samples) * scale, 4)
        return out


class ZipfSampler:
    """Zipf-skewed object index draw: P(i) ~ 1/(i+1)^alpha over
    n_objects, so a small hot set takes most of the traffic (the
    skew every production object store sees).  alpha=0 degenerates
    to uniform.  Draws are cheap: precomputed CDF + searchsorted."""

    def __init__(self, n_objects: int, alpha: float = 1.1,
                 seed: int = 0):
        if n_objects < 1:
            raise ValueError("n_objects must be >= 1")
        self.n_objects = n_objects
        ranks = np.arange(1, n_objects + 1, dtype=np.float64)
        weights = ranks ** -float(alpha)
        self._cdf = np.cumsum(weights) / weights.sum()
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def draw(self) -> int:
        with self._lock:
            u = self._rng.random()
        return int(np.searchsorted(self._cdf, u))

    def spawn(self, seed: int) -> "ZipfSampler":
        """A per-worker sampler sharing the CDF but not the rng lock."""
        child = object.__new__(ZipfSampler)
        child.n_objects = self.n_objects
        child._cdf = self._cdf
        child._rng = np.random.default_rng(seed)
        child._lock = threading.Lock()
        return child


def burst_gaps(rate: float, n: int, burst_factor: float = 1.0,
               burst_every: int = 0, burst_len: int = 0,
               seed: int = 0):
    """Inter-arrival gaps (seconds) for an open-loop schedule of `n`
    ops at `rate` ops/sec per worker: exponential (Poisson) gaps, with
    every `burst_every`-th stretch of `burst_len` ops arriving at
    burst_factor * rate — the on/off burst shape that makes queues
    (and p99s) honest.  burst_factor=1 or burst_every=0 is a plain
    Poisson process; rate<=0 yields zero gaps (closed loop)."""
    if rate <= 0:
        for _ in range(n):
            yield 0.0
        return
    rng = np.random.default_rng(seed)
    for i in range(n):
        r = rate
        if burst_every > 0 and burst_len > 0 and \
                (i % burst_every) < burst_len:
            r = rate * max(burst_factor, 1e-9)
        yield float(rng.exponential(1.0 / r))

"""The closed loop of a window: `in_flight` calls outstanding, the next
issued as soon as the oldest is seen done.

A call's latency runs from the host clock just before the call to the
moment its completion is seen done; its dispatch is the host time from
the call to its return.  The window opens before the first call and
closes when the last call issued before `seconds` ran out is done, so a
rate divides all the work by all the time.  With a tracer, the first
`trace_seconds` of the window run under it and are drained before it
stops; the window then goes on untraced for the rest of `seconds`, and
the tracer's own stop is not in the window.

The outputs of a sample of calls, drawn from the seed, are kept for the
comparison after the window: one call from each of VERIFY_STRATA equal
strata of the calls the window is expected to hold, and the last.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

VERIFY_STRATA = 16


@dataclasses.dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    dispatch: list = dataclasses.field(default_factory=list)
    traced_calls: int = 0
    samples: list = dataclasses.field(default_factory=list)
    launches: int = 0


def _annotate(name: str, on: bool):
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def sample_plan(rng: np.random.Generator, expected_calls: int,
                strata: int = VERIFY_STRATA) -> set[int]:
    size = max(1, expected_calls // strata)
    return {s * size + int(rng.integers(size)) for s in range(strata)}


def run(entry, seconds: float, in_flight: int, sampled: set[int],
        tracer=None, trace_seconds: float = 0.0,
        stop_after: int | None = None) -> Window:
    from ceph_tpu_torch.ops import bitsliced as bs
    w = Window()
    launches0 = sum(bs.launch_counts().values())
    last: list = []

    def phase(i: int, span: float, traced: bool) -> int:
        """Calls from index i for `span` seconds, then drained."""
        pending: collections.deque = collections.deque()

        def retire():
            _, t_start, done, out = pending.popleft()
            with _annotate("bench.wait", traced):
                done.synchronize()
            w.latencies.append(time.perf_counter() - t_start)
            if out is not None:
                w.samples.append(entry.finish(out))

        t0 = time.perf_counter()
        while time.perf_counter() - t0 < span and \
                (stop_after is None or i < stop_after):
            t_call = time.perf_counter()
            with _annotate("bench.dispatch", traced):
                out = entry.call(i)
            w.dispatch.append(time.perf_counter() - t_call)
            last[:] = [(i, out)]
            pending.append((i, t_call, entry.completion(out),
                            out if i in sampled else None))
            del out
            i += 1
            if len(pending) >= in_flight:
                retire()
        while pending:
            retire()
        w.seconds += time.perf_counter() - t0
        return i

    i = 0
    if tracer is not None:
        tracer.start()
        i = phase(i, min(trace_seconds, seconds), True)
        tracer.stop()
        w.traced_calls = i
        seconds -= w.seconds
    i = phase(i, seconds, False)
    w.calls = i
    if last and last[0][0] not in sampled:
        w.samples.append(entry.finish(last[0][1]))
    w.launches = sum(bs.launch_counts().values()) - launches0
    return w

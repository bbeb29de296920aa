"""One run of one cell: set-up, warm-up, the window, the comparison
with the reference, and the result line."""

from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path

import numpy as np
import torch

from . import cells, loop, roofline
from .entry import build as build_entry
from .trace import Trace, Tracer, summarize

TOP = 10
# calls after the warm-up that time one call, to spread the sample
ESTIMATE_CALLS = 8
# the head of a --trace 1 window that runs under the profiler
TRACE_SECONDS = 3.0


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    window: loop.Window
    trace: Trace | None
    least_traced_s: float | None   # the traced calls' least time


def _e2e(name: str, entry, w: loop.Window, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name == "call_p95_ms":
        return float(np.percentile(np.asarray(w.latencies), 95) * 1e3)
    if name == entry.metric:
        return w.calls * entry.work_bytes() / w.seconds / 1e9
    raise ValueError(f"the {type(entry).__name__} entry does not report "
                     f"{name!r}")


def _warm(entry, device: torch.device, in_flight: int) -> float:
    """Every shape the cell's calls use, once; then seconds a call in
    the closed loop, from ESTIMATE_CALLS more."""
    for shape in entry.shapes():
        out = entry.warm_call(shape)
        entry.completion(out).synchronize()
        entry.finish(out)
    w = loop.run(entry, float("inf"), in_flight, set(),
                 stop_after=ESTIMATE_CALLS)
    return w.seconds / max(1, w.calls)


def _hold(entry, count: int) -> None:
    """Run `count` calls and hold their outputs together, so that the
    allocator has cached the blocks the window's kept samples take."""
    held = []
    for i in range(count):
        out = entry.call(i)
        entry.completion(out).synchronize()
        held.append(entry.finish(out))
    del held


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, started: float,
             log=print, control: bool = False,
             marks: dict | None = None) -> dict:
    """Run `workload` once and return its result line (a dict).
    `started` is the process's start on the time.time() clock; `marks`
    the seconds from it at which the caller passed its own stages.

    setup_s runs from `started` to the first timed call, less the
    seconds the reference spends making a cell's inputs (the entry's
    `reference_s`, printed as the stage `reference`)."""
    cell = cells.resolve(root, workload)
    tr = cell.traffic
    in_flight = int(tr["in_flight"])
    stages = dict(marks or {})
    stages["start"] = time.time() - started
    entry = build_entry(root, cell.config, tr, device, seed, control)
    try:
        for key, val in entry.info.items():
            log(f"{key} {val}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        stages["inputs"] = time.time() - started
        per_call = _warm(entry, device, in_flight)
        expected = int(seconds / per_call) if per_call > 0 else 1
        sampled = loop.sample_plan(np.random.default_rng([seed, 1]),
                                   max(1, expected))
        _hold(entry, len(sampled) + in_flight + 1)
        tracer = Tracer() if trace else None
        # no cyclic collection of set-up's objects inside the window
        gc.collect()
        gc.freeze()
        gc.disable()
        stages["warm"] = time.time() - started
        stages["reference"] = entry.reference_s
        setup_s = stages["warm"] - entry.reference_s
        log("setup_stages " + " ".join(f"{k}={v:.3f}"
                                       for k, v in stages.items()))
        try:
            w = loop.run(entry, seconds, in_flight, sampled, tracer,
                         TRACE_SECONDS)
        finally:
            gc.enable()
            gc.unfreeze()
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        entry.free_inputs()
        checks, bad = entry.check(w.samples)
    finally:
        entry.close()
    correct = bool(w.samples) and all(v <= lim for v, lim in checks.values())
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": w.calls, "failed": bad}
    if not trace:
        result["metrics"] = {
            m["name"]: {"value": _e2e(m["name"], entry, w, setup_s),
                        "unit": m["unit"]} for m in cell.end_to_end}
    else:
        summary = summarize(tracer.events())
        if device.type == "cuda" and summary is None:
            raise RuntimeError("the device trace holds no operation")
        least = None
        if summary is not None:
            nbytes, ops = entry.cost()
            least = roofline.least_seconds(kind, nbytes * w.traced_calls,
                                           ops * w.traced_calls)
        ctx = Context(w, summary, least)
        metrics = {}
        for m in cell.per_layer:
            val = cells.load_reader(root, m["name"])(ctx, m["name"])
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        result["metrics"] = metrics
        if summary is not None:
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = summary.window_s
            result["breakdown"] = {
                "device_ops": [[n, s] for n, s in summary.ops[:TOP]],
                "idle_gaps": [[n, s] for n, s in summary.idle[:TOP]]}
    result["device"] = dev
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    result["checks"]["calls_checked"] = {"value": len(w.samples),
                                         "at_least": 1}
    return result

"""The device trace of a window's traced part, from torch.profiler.

The profiler records the card's kernels, copies and fills beside the
host spans the loop marks (`bench.dispatch` around each call into the
program, `bench.wait` around each wait for a completion).  From its
Chrome trace come: every device operation's interval, their union
(the time the card was busy), the traced window (the first host span's
start to the last device operation's end), the device operations with
the most time, and the card's idle gaps by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_SPANS = {"bench.dispatch": "idle_in_dispatch",
              "bench.wait": "idle_in_wait"}


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float          # the union of device operations' intervals
    device_s: float        # their sum
    ops: list              # (name, seconds), most first
    idle: list             # (what the host did, seconds), most first


class Tracer:
    def __init__(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.started = False

    def start(self) -> None:
        self.prof.start()
        self.started = True

    def stop(self) -> None:
        if self.started:
            self.started = False
            self.prof.stop()

    def events(self) -> list:
        """The trace's events (read after stop)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return data.get("traceEvents", []) if isinstance(data, dict) \
            else data


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> Trace | None:
    """The traced window's figures, or None where the trace holds no
    device operation."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((a, b, str(e.get("name", "?"))))
        elif cat == "user_annotation" and e.get("name") in HOST_SPANS:
            host.append((a, b, HOST_SPANS[e["name"]]))
    if not dev:
        return None
    start = min([a for a, _, _ in host] + [a for a, _, _ in dev])
    end = max(b for _, b, _ in dev)
    busy = _merge([(a, b) for a, b, _ in dev])
    by_op: dict[str, float] = {}
    for a, b, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    gaps = []
    t = start
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host.sort()
    idle: dict[str, float] = {}
    hi = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while hi < len(host) and host[hi][1] < mid:
            hi += 1
        what = "idle_in_loop"
        for ha, hb, name in host[hi:hi + 4]:
            if ha <= mid <= hb:
                what = name
                break
        idle[what] = idle.get(what, 0.0) + (b - a) / 1e6
    return Trace(window_s=(end - start) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 device_s=sum(by_op.values()),
                 ops=sorted(by_op.items(), key=lambda kv: -kv[1]),
                 idle=sorted(idle.items(), key=lambda kv: -kv[1]))

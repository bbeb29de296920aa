"""dout-style subsystem logging with a crash-dump ring.

Re-expresses the reference's logging (src/common/dout.h macro family,
src/common/subsys.h 62 subsystems, src/log/Log.h async collector):
per-subsystem log/gather levels, cheap level gating, and an in-memory
ring kept at higher verbosity than what reaches the sink, dumped on
crash ("recent events") — the feature that makes field debugging of a
storage daemon possible.

The port's copy of ceph_tpu/common/dout.py (standard library only).
"""

from __future__ import annotations

import collections
import sys
import threading
import time

SUBSYS = {
    # (log_level, gather_level) defaults, reference subsys.h style
    "osd": (1, 5),
    "ec": (1, 5),
    "ms": (0, 5),
    "mon": (1, 5),
    "crush": (1, 5),
    "store": (1, 5),
    "tpu": (1, 5),
    "client": (1, 5),
    "scrub": (1, 5),
}


class LogRing:
    """In-memory recent-events ring (reference m_recent)."""

    def __init__(self, capacity: int = 10000):
        self.ring = collections.deque(maxlen=capacity)
        self.lock = threading.Lock()

    def add(self, entry: tuple) -> None:
        with self.lock:
            self.ring.append(entry)

    def __len__(self) -> int:
        with self.lock:
            return len(self.ring)

    def recent(self, count: int | None = None) -> list[tuple]:
        """Tail of the ring, newest last (allocation-light: entries
        stay tuples; formatting happens only at dump time)."""
        with self.lock:
            entries = list(self.ring)
        if count is not None:
            entries = entries[-count:] if count > 0 else []
        return entries

    def dump(self, out=sys.stderr) -> None:
        with self.lock:
            entries = list(self.ring)
        print(f"--- begin dump of recent events ({len(entries)}) ---",
              file=out)
        for ts, subsys, level, msg in entries:
            print(f"{ts:.6f} {subsys:>6} {level} : {msg}", file=out)
        print("--- end dump of recent events ---", file=out)


class DoutStream:
    def __init__(self, sink=None):
        self.levels = dict(SUBSYS)
        self.ring = LogRing()
        self.sink = sink if sink is not None else sys.stderr
        self.name = ""

    def set_level(self, subsys: str, log: int, gather: int | None = None):
        g = gather if gather is not None else max(
            log, self.levels.get(subsys, (1, 5))[1])
        self.levels[subsys] = (log, g)

    def should_gather(self, subsys: str, level: int) -> bool:
        return level <= self.levels.get(subsys, (1, 5))[1]

    def log(self, subsys: str, level: int, msg: str) -> None:
        log_lvl, gather_lvl = self.levels.get(subsys, (1, 5))
        if level > gather_lvl:
            return
        ts = time.time()
        self.ring.add((ts, subsys, level, msg))
        if level <= log_lvl:
            try:
                print(f"{ts:.6f} {self.name} {subsys:>6} {level} : {msg}",
                      file=self.sink)
            except ValueError:
                pass   # sink closed (daemon thread logging at teardown)

    def dump_recent(self, out=sys.stderr) -> None:
        self.ring.dump(out)

    def recent(self, count: int | None = None) -> list[dict]:
        """Structured view of the recent-events ring (the `log dump`
        asok command payload)."""
        return [{"ts": ts, "subsys": subsys, "level": level, "msg": msg}
                for ts, subsys, level, msg in self.ring.recent(count)]


_default = DoutStream()


def dout(subsys: str, level: int, msg: str,
         stream: DoutStream | None = None) -> None:
    (stream or _default).log(subsys, level, msg)


def default_stream() -> DoutStream:
    return _default

"""Lockdep: lock-order cycle detection (reference src/common/lockdep.cc).

The reference registers every named mutex, records the per-thread
acquisition ORDER as a directed graph, and aborts when an acquisition
would close a cycle — catching ABBA deadlocks on the first run that
exercises both orders, even if the timing never actually deadlocks.

Same design here, as an opt-in instrument (the reference enables
lockdep in debug builds and test runs only):

    handle = lockdep.instrument()
    try:
        ... run the workload ...
    finally:
        handle.restore()
    handle.check()     # raises LockOrderError on any cycle seen

instrument() patches threading.Lock/RLock so EVERY lock created while
instrumented participates — daemon-internal locks included, no code
changes.  Edges record the stacks of both acquisitions so a report
says who took what in which order.  RLock re-entry and locks acquired
with blocking=False that fail are ignored (neither can deadlock).
"""

from __future__ import annotations

import threading
import traceback

_real_lock = threading.Lock
_real_rlock = threading.RLock


class LockOrderError(AssertionError):
    pass


class _Graph:
    """Order graph: edge a->b = 'a was held while acquiring b'."""

    def __init__(self):
        self.edges: dict[int, set[int]] = {}
        self.names: dict[int, str] = {}
        self.sites: dict[tuple[int, int], str] = {}
        self.cycles: list[str] = []
        self.mu = _real_lock()

    def _reaches(self, src: int, dst: int) -> bool:
        seen = set()
        stack = [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self.edges.get(n, ()))
        return False

    def add_edge(self, a: int, b: int, site: str) -> None:
        with self.mu:
            if b in self.edges.get(a, ()):
                return
            if self._reaches(b, a):
                back = self.sites.get((b, a)) or next(
                    (self.sites[(b, x)] for x in self.edges.get(b, ())
                     if (b, x) in self.sites), "?")
                self.cycles.append(
                    f"lock order cycle: {self.names.get(a, a)} -> "
                    f"{self.names.get(b, b)} at\n{site}\n"
                    f"while the reverse order was seen at\n{back}")
                return
            self.edges.setdefault(a, set()).add(b)
            self.sites[(a, b)] = site


class _Held(threading.local):
    def __init__(self):
        self.stack: list[int] = []


class _LockdepBase:
    """Shared wrapper: order tracking around a real lock."""

    _factory = None

    def __init__(self, name: str | None = None):
        self._lk = self._factory()
        # serial ids, not id(self): a GC'd lock's reused address would
        # inherit stale graph edges and report false cycles (the
        # reference lockdep unregisters freed locks for the same
        # reason)
        with _SERIAL_MU:
            _STATE["serial"] += 1
            self._id = _STATE["serial"]
        g = _STATE["graph"]
        if g is not None:
            g.names[self._id] = name or \
                f"{type(self).__name__}#{self._id}"

    def _record(self):
        g = _STATE["graph"]
        if g is None:
            return
        held = _STATE["held"].stack
        if held and held[-1] != self._id:
            site = "".join(traceback.format_stack(limit=8)[:-2])
            for h in held:
                if h != self._id:
                    g.add_edge(h, self._id, site)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            self._record()
        ok = self._lk.acquire(blocking, timeout) if timeout != -1 else \
            self._lk.acquire(blocking)
        if ok:
            _STATE["held"].stack.append(self._id)
        return ok

    def release(self):
        held = _STATE["held"].stack
        if self._id in held:
            held.reverse()
            held.remove(self._id)
            held.reverse()
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._lk.locked()


class LockdepLock(_LockdepBase):
    _factory = staticmethod(_real_lock)


class LockdepRLock(_LockdepBase):
    _factory = staticmethod(_real_rlock)

    def _record(self):
        # re-entry of a held RLock cannot deadlock: skip the edge
        if self._id in _STATE["held"].stack:
            return
        super()._record()

    # (release bookkeeping is inherited from _LockdepBase)

    # Condition-variable hooks MUST come from the real RLock: the
    # stdlib's generic _is_owned fallback probes acquire(False), which
    # SUCCEEDS on a reentrant lock the caller owns and misreports
    # "un-acquired" (breaking every Future/Event built on Condition()).
    def _is_owned(self):
        return self._lk._is_owned()

    def _release_save(self):
        return self._lk._release_save()

    def _acquire_restore(self, state):
        return self._lk._acquire_restore(state)


_STATE: dict = {"graph": None, "held": _Held(), "serial": 0}
_SERIAL_MU = _real_lock()


class Handle:
    def __init__(self, graph: _Graph):
        self.graph = graph

    def restore(self) -> None:
        threading.Lock = _real_lock
        threading.RLock = _real_rlock
        _STATE["graph"] = None

    def check(self) -> None:
        """Raise if any acquisition closed an order cycle."""
        if self.graph.cycles:
            raise LockOrderError(
                f"{len(self.graph.cycles)} lock-order cycle(s):\n\n"
                + "\n\n".join(self.graph.cycles[:5]))

    def edge_count(self) -> int:
        return sum(len(v) for v in self.graph.edges.values())


def instrument() -> Handle:
    """Patch threading.Lock/RLock so every lock created from now on is
    order-tracked; returns the handle for restore()/check()."""
    # stdlib modules that lazily self-initialize with threading.Lock at
    # first import must load BEFORE the patch
    import concurrent.futures.thread  # noqa: F401
    graph = _Graph()
    _STATE["graph"] = graph
    threading.Lock = LockdepLock
    threading.RLock = LockdepRLock
    return Handle(graph)

"""ExtentCache: in-flight written extents for overlapping EC overwrites.

Re-expresses reference src/osd/ExtentCache.{h,cc}: while a write's
sub-ops are in flight, its stripe-aligned extents stay readable by
later ops in the pipeline, so an overlapping RMW doesn't re-read stale
bytes from the store (reserve/present/release around the pipeline,
reference ECBackend.cc:1902,1959,2020).  Ref-counted per extent: the
same range may be pinned by several queued ops.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from .types import hobject_t


@dataclass
class _Extent:
    off: int
    data: np.ndarray
    refs: int = 1

    @property
    def end(self) -> int:
        return self.off + self.data.size


class ExtentCache:
    def __init__(self) -> None:
        self._objs: dict[hobject_t, list[_Extent]] = {}
        self._lock = threading.Lock()

    def present(self, oid: hobject_t, off: int, data: np.ndarray) -> None:
        """Pin an assembled extent (newest data wins on overlap)."""
        with self._lock:
            exts = self._objs.setdefault(oid, [])
            for e in exts:
                if e.off == off and e.data.size == data.size:
                    e.data = np.asarray(data, dtype=np.uint8).copy()
                    e.refs += 1
                    return
            exts.append(_Extent(off,
                                np.asarray(data, dtype=np.uint8).copy()))

    def overlay(self, oid: hobject_t, off: int,
                buf: np.ndarray) -> np.ndarray:
        """Copy any cached bytes intersecting [off, off+len(buf)) over
        buf (newest extents last in the list = freshest)."""
        with self._lock:
            exts = list(self._objs.get(oid, []))
        end = off + buf.size
        for e in exts:
            lo, hi = max(off, e.off), min(end, e.end)
            if lo < hi:
                buf[lo - off:hi - off] = e.data[lo - e.off:hi - e.off]
        return buf

    def release(self, oid: hobject_t, off: int, length: int) -> None:
        with self._lock:
            exts = self._objs.get(oid)
            if not exts:
                return
            for e in list(exts):
                if e.off == off and e.data.size == length:
                    e.refs -= 1
                    if e.refs <= 0:
                        exts.remove(e)
                    break
            if not exts:
                del self._objs[oid]

    def clear_object(self, oid: hobject_t) -> None:
        with self._lock:
            self._objs.pop(oid, None)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._objs.values())

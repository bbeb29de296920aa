"""bufferlist — the zero-copy rope that is the data-plane currency.

Re-expresses the reference's `ceph::bufferlist`/`bufferptr`
(src/include/buffer.h:441, src/common/buffer.cc): an ordered list of
byte segments supporting append without copy, substr views, alignment
rebuilds, and crc32c with a per-segment crc cache (reference keeps the
crc cache on the raw buffer, :1199 + buffer.cc crc_map) so repeated
checksums of unchanged data are free and crcs of concatenations combine
in O(log n) instead of re-scanning bytes.

Idiomatic difference: segments are numpy uint8 arrays (zero-copy views
of bytes/memoryview/ndarray), which is what both the TPU path (device
transfer wants contiguous aligned pages) and the native path (ctypes
pointers) consume directly.
"""

from __future__ import annotations

import numpy as np

from . import crc32c as _crc


class BufferPtr:
    """One segment: a numpy view plus its cached crc (keyed by seed)."""

    __slots__ = ("array", "_crc_cache")

    def __init__(self, data):
        if isinstance(data, np.ndarray):
            self.array = data.astype(np.uint8, copy=False).ravel()
        else:
            self.array = np.frombuffer(data, dtype=np.uint8)
        self._crc_cache: dict[int, int] = {}

    def __len__(self) -> int:
        return self.array.size

    def crc32c(self, seed: int) -> int:
        got = self._crc_cache.get(seed)
        if got is None:
            got = _crc.crc32c(self.array.tobytes(), seed)
            self._crc_cache[seed] = got
        return got


class BufferList:
    """Rope of BufferPtr segments."""

    def __init__(self, data=None):
        self._ptrs: list[BufferPtr] = []
        self._length = 0
        if data is not None:
            self.append(data)

    # -- building -----------------------------------------------------------

    def append(self, data) -> None:
        if isinstance(data, BufferList):
            self._ptrs.extend(data._ptrs)
            self._length += data._length
            return
        ptr = data if isinstance(data, BufferPtr) else BufferPtr(data)
        if len(ptr):
            self._ptrs.append(ptr)
            self._length += len(ptr)

    def append_zero(self, n: int) -> None:
        if n > 0:
            self.append(np.zeros(n, dtype=np.uint8))

    def __len__(self) -> int:
        return self._length

    def clear(self) -> None:
        self._ptrs.clear()
        self._length = 0

    # -- reading ------------------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """Contiguous view; zero-copy when single-segment."""
        if len(self._ptrs) == 1:
            return self._ptrs[0].array
        if not self._ptrs:
            return np.empty(0, dtype=np.uint8)
        return np.concatenate([p.array for p in self._ptrs])

    def to_bytes(self) -> bytes:
        return self.to_numpy().tobytes()

    def substr(self, off: int, length: int) -> "BufferList":
        """View of [off, off+length) without copying segment bodies."""
        if off < 0 or off + length > self._length:
            raise IndexError(f"substr({off}, {length}) of {self._length}")
        out = BufferList()
        pos = 0
        remaining = length
        for p in self._ptrs:
            if remaining == 0:
                break
            seg_end = pos + len(p)
            if seg_end <= off:
                pos = seg_end
                continue
            start = max(0, off - pos)
            take = min(len(p) - start, remaining)
            out.append(p.array[start:start + take])
            remaining -= take
            pos = seg_end
        return out

    # -- layout -------------------------------------------------------------

    def is_contiguous(self) -> bool:
        return len(self._ptrs) <= 1

    def rebuild(self) -> None:
        """Coalesce into one segment (reference bufferlist::rebuild)."""
        arr = self.to_numpy().copy()
        self._ptrs = [BufferPtr(arr)] if arr.size else []

    def rebuild_aligned(self, align: int) -> None:
        """Coalesce into one segment whose base is `align`-aligned
        (reference rebuild_aligned, used by the EC benchmark at
        ceph_erasure_code_benchmark.cc:170)."""
        arr = self.to_numpy()
        padded = np.empty(arr.size + align, dtype=np.uint8)
        off = (-padded.ctypes.data) % align
        aligned = padded[off:off + arr.size]
        aligned[:] = arr
        self._ptrs = [BufferPtr(aligned)] if arr.size else []

    # -- checksum -----------------------------------------------------------

    def crc32c(self, seed: int = 0xFFFFFFFF) -> int:
        """crc over all segments, combining per-segment cached crcs
        (reference buffer.h:1199 semantics: cache hit when the same
        segment was crc'd before with a seed we can shift from)."""
        crc = seed & 0xFFFFFFFF
        for p in self._ptrs:
            # Per-segment cache is seeded at 0; combine shifts it under
            # the running crc.  (cache(0) then combine == crc(run) over
            # segment bytes, by linearity of crc.)
            seg = p.crc32c(0)
            crc = _crc.crc32c_combine(crc, seg, len(p))
        return crc

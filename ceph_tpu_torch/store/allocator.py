"""Block allocator for the raw-block store.

Re-expresses reference src/os/bluestore/Allocator.h (+ the btree/bitmap
allocator family) at the policy this store needs: first-fit over an
offset-sorted free-extent map with merge-on-release, min_alloc_size
granularity, and grow-on-demand (the "device" is a plain file, so
running past the end extends it instead of ENOSPC).

The free map is NOT persisted: mount rebuilds it by walking every
onode's blob extents (the role of BlueStore's fsck-style realloc;
the reference persists a FreelistManager in the KV — rebuilding from
authoritative metadata is the simpler crash-safe equivalent at this
scale, and makes allocator state impossible to desync from the onodes).
"""

from __future__ import annotations

import threading


class Allocator:
    def __init__(self, size: int, min_alloc: int = 4096):
        self.min_alloc = min_alloc
        self.size = size
        self._lock = threading.Lock()
        # offset -> length of free extents, kept merged + sorted
        self._free: dict[int, int] = {0: size} if size else {}

    # -- carving -------------------------------------------------------------

    def allocate(self, want: int) -> list[tuple[int, int]]:
        """First-fit extents totalling `want` (rounded up to
        min_alloc); grows the device when free space runs out."""
        want = -(-want // self.min_alloc) * self.min_alloc
        out: list[tuple[int, int]] = []
        with self._lock:
            remaining = want
            for off in sorted(self._free):
                if remaining <= 0:
                    break
                length = self._free.pop(off)
                take = min(length, remaining)
                out.append((off, take))
                if take < length:
                    self._free[off + take] = length - take
                remaining -= take
            if remaining > 0:
                # grow the device file
                out.append((self.size, remaining))
                self.size += remaining
        return out

    def release(self, extents) -> None:
        with self._lock:
            for off, length in extents:
                self._free[off] = length
            self._merge()

    def mark_used(self, off: int, length: int) -> None:
        """Carve a specific range out of the free map (mount-time
        rebuild from onode metadata)."""
        with self._lock:
            if off + length > self.size:
                self.size = off + length
            for foff in sorted(self._free):
                flen = self._free[foff]
                fend = foff + flen
                if fend <= off or foff >= off + length:
                    continue
                del self._free[foff]
                if foff < off:
                    self._free[foff] = off - foff
                if fend > off + length:
                    self._free[off + length] = fend - (off + length)

    def _merge(self) -> None:
        merged: dict[int, int] = {}
        last_off = last_len = None
        for off in sorted(self._free):
            length = self._free[off]
            if last_off is not None and last_off + last_len == off:
                last_len += length
            else:
                if last_off is not None:
                    merged[last_off] = last_len
                last_off, last_len = off, length
        if last_off is not None:
            merged[last_off] = last_len
        self._free = merged

    def free_bytes(self) -> int:
        with self._lock:
            return sum(self._free.values())

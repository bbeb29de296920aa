"""RBD object map: which data blocks exist, without probing the OSDs.

Re-expresses reference src/librbd/ObjectMap.h + object_map/ (state
bitmap per data object, maintained under the exclusive lock, consulted
by reads/copyup/diff and backing `rbd du`-style accounting).  The map
is one byte per block (OBJECT_NONEXISTENT / OBJECT_EXISTS) in a
`rbd_object_map.<image>` RADOS object; updates are one-byte
offset-writes, applied WRITE-AHEAD of the data op exactly like the
reference (a block is marked EXISTS before its first write, and
NONEXISTENT only after its object is removed, so a crash between the
two leaves the map conservative, never wrong).

Only an exclusive-lock owner maintains the map (reference gates the
object-map feature on the lock); lockless handles fall back to OSD
probes.
"""

from __future__ import annotations

import errno

from ..rados.client import RadosError

NONEXISTENT = 0
EXISTS = 1


def _map_oid(name: str) -> str:
    return f"rbd_object_map.{name}"


def _inval_oid(name: str) -> str:
    return f"rbd_object_map_inval.{name}"


def invalidate(io, name: str) -> None:
    """Flag the map untrustworthy (reference FLAG_OBJECT_MAP_INVALID):
    a sentinel object, NOT removal of the map — a live lock owner's
    one-byte updates would silently recreate a short, mostly-zero map
    object, which the next loader would wrongly trust."""
    io.write_full(_inval_oid(name), b"1")


class ObjectMap:
    def __init__(self, ioctx, image_name: str, nblocks: int):
        self.io = ioctx
        self.name = image_name
        self.nblocks = nblocks
        self.state = bytearray(nblocks)
        self._loaded = False

    # -- load / rebuild ------------------------------------------------------

    def load(self, probe_block) -> None:
        """Read the persisted map; rebuild by probing each block when
        it is absent (pre-object-map image), flagged invalid by a
        lockless writer, or its size disagrees with the image
        (reference rbd object-map rebuild + FLAG_OBJECT_MAP_INVALID)."""
        invalid = True
        try:
            self.io.read(_inval_oid(self.name), 1, snap=0)
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
            invalid = False
        if not invalid:
            try:
                raw = bytes(self.io.read(_map_oid(self.name), 0, snap=0))
                if len(raw) == self.nblocks:
                    self.state = bytearray(raw)
                    self._loaded = True
                    return
                # size mismatch: stale map — rebuild everything (a
                # partially-trusted map can mark live data absent)
            except RadosError as e:
                if e.errno != errno.ENOENT:
                    raise
        for b in range(self.nblocks):
            self.state[b] = EXISTS if probe_block(b) else NONEXISTENT
        self.io.write_full(_map_oid(self.name), bytes(self.state))
        try:
            self.io.remove(_inval_oid(self.name))
        except RadosError:
            pass
        self._loaded = True

    # -- queries -------------------------------------------------------------

    def object_may_exist(self, block: int) -> bool:
        if not self._loaded or block >= self.nblocks:
            return True               # conservative without a map
        return self.state[block] == EXISTS

    def used_bytes(self, block_size: int) -> int:
        """rbd du role (fast-diff accounting): EXISTS blocks only."""
        return sum(1 for s in self.state if s == EXISTS) * block_size

    # -- write-ahead updates -------------------------------------------------

    def ensure_exists(self, block: int) -> None:
        """Mark EXISTS before the data write lands."""
        if not self._loaded or block >= self.nblocks:
            return
        if self.state[block] != EXISTS:
            self.io.write(_map_oid(self.name), bytes([EXISTS]),
                          offset=block)
            self.state[block] = EXISTS

    def mark_removed(self, block: int) -> None:
        """Mark NONEXISTENT after the data object is removed."""
        if not self._loaded or block >= self.nblocks:
            return
        if self.state[block] != NONEXISTENT:
            self.io.write(_map_oid(self.name), bytes([NONEXISTENT]),
                          offset=block)
            self.state[block] = NONEXISTENT

    def resize(self, nblocks: int, exists_hint: int = NONEXISTENT) -> None:
        if nblocks < len(self.state):
            del self.state[nblocks:]
        else:
            self.state.extend(bytes([exists_hint]) *
                              (nblocks - len(self.state)))
        self.nblocks = nblocks
        if self._loaded:
            self.io.write_full(_map_oid(self.name), bytes(self.state))

    def remove(self) -> None:
        try:
            self.io.remove(_map_oid(self.name))
        except RadosError:
            pass

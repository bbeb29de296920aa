"""Client-side striping over RADOS objects.

Re-expresses reference src/libradosstriper/ (RadosStriperImpl): a large
logical object is striped over many RADOS objects with a
(stripe_unit, stripe_count, object_size) policy — the storage analog of
sequence sharding (SURVEY.md section 5 "long-context").  Layout matches
the reference's: stripe units round-robin across a set of
`stripe_count` objects until each reaches `object_size`, then the next
object set begins.  The logical size rides an xattr on the first
object.
"""

from __future__ import annotations

import errno

from .client import IoCtx, RadosError

SIZE_XATTR = "striper.size"
LAYOUT_XATTR = "striper.layout"


class StripedObject:
    def __init__(self, ioctx: IoCtx, name: str,
                 stripe_unit: int = 4096, stripe_count: int = 4,
                 object_size: int = 1 << 22):
        assert object_size % stripe_unit == 0
        self.io = ioctx
        self.name = name
        self.su = stripe_unit
        self.sc = stripe_count
        self.os_ = object_size

    def _piece(self, idx: int) -> str:
        return f"{self.name}.{idx:016x}"

    def _map(self, off: int) -> tuple[int, int, int]:
        """logical offset -> (object index, object offset, run length
        to the end of this stripe unit)."""
        set_size = self.os_ * self.sc          # bytes per object set
        set_idx, set_off = divmod(off, set_size)
        stripe, stripe_off = divmod(set_off, self.su * self.sc)
        within, unit_off = divmod(stripe_off, self.su)
        obj_idx = set_idx * self.sc + within
        obj_off = stripe * self.su + unit_off
        run = self.su - unit_off
        return obj_idx, obj_off, run

    # -- I/O ----------------------------------------------------------------

    def write(self, data: bytes, offset: int = 0) -> None:
        pos = 0
        while pos < len(data):
            obj_idx, obj_off, run = self._map(offset + pos)
            chunk = data[pos:pos + run]
            self.io.write(self._piece(obj_idx), chunk, offset=obj_off)
            pos += len(chunk)
        new_size = offset + len(data)
        if new_size > self.size():
            self._set_size(new_size)

    def read(self, length: int | None = None, offset: int = 0) -> bytes:
        size = self.size()
        if length is None:
            length = size - offset
        length = max(0, min(length, size - offset))
        out = bytearray()
        pos = 0
        while pos < length:
            obj_idx, obj_off, run = self._map(offset + pos)
            want = min(run, length - pos)
            try:
                piece = self.io.read(self._piece(obj_idx), want, obj_off)
            except RadosError as e:
                if e.errno == errno.ENOENT:
                    piece = b"\0" * want     # sparse hole
                else:
                    raise
            if len(piece) < want:
                piece = piece + b"\0" * (want - len(piece))
            out += piece
            pos += want
        return bytes(out)

    def size(self) -> int:
        """Logical size from the striper metadata object (the reference
        keeps it in an xattr of piece 0; our IoCtx surface keeps object
        data as the metadata channel)."""
        try:
            raw = self.io.read(self._size_obj(), 0)
            return int(raw.decode() or "0")
        except RadosError:
            return 0

    def _size_obj(self) -> str:
        return f"{self.name}.striper_meta"

    def _set_size(self, size: int) -> None:
        self.io.write_full(self._size_obj(), str(size).encode())

    def remove(self) -> None:
        size = self.size()
        set_size = self.os_ * self.sc
        nsets = -(-max(size, 1) // set_size)
        for idx in range(nsets * self.sc):
            try:
                self.io.remove(self._piece(idx))
            except RadosError:
                pass
        try:
            self.io.remove(self._size_obj())
        except RadosError:
            pass

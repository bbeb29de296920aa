"""MemStore: in-memory ObjectStore (reference src/os/memstore/MemStore.h:30).

The fake backend unit/standalone tests run against for speed; also the
store of chip_smoke.py's main path.  Thread-safe; commits are
immediate (fsync-free), callbacks fire synchronously in queue order.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from ..osd.types import ghobject_t, spg_t
from . import object_store as os_
from .object_store import ObjectStore, Transaction


@dataclass
class _Object:
    data: bytearray = field(default_factory=bytearray)
    xattrs: dict[str, bytes] = field(default_factory=dict)
    omap: dict[bytes, bytes] = field(default_factory=dict)
    omap_header: bytes = b""

    def clone(self) -> "_Object":
        return _Object(bytearray(self.data), dict(self.xattrs),
                       dict(self.omap), self.omap_header)


class MemStore(ObjectStore):
    def __init__(self) -> None:
        self._colls: dict[spg_t, dict[ghobject_t, _Object]] = {}
        self._lock = threading.RLock()
        self._mounted = False

    # -- lifecycle ----------------------------------------------------------

    def mount(self) -> None:
        self._mounted = True

    def umount(self) -> None:
        self._mounted = False

    # -- collections --------------------------------------------------------

    def create_collection(self, cid: spg_t) -> None:
        with self._lock:
            self._colls.setdefault(cid, {})

    def remove_collection(self, cid: spg_t) -> None:
        with self._lock:
            self._colls.pop(cid, None)

    def list_collections(self) -> list[spg_t]:
        with self._lock:
            return sorted(self._colls)

    def collection_exists(self, cid: spg_t) -> bool:
        with self._lock:
            return cid in self._colls

    # -- transactions -------------------------------------------------------

    def queue_transactions(self, cid: spg_t,
                           txns: Iterable[Transaction]) -> None:
        callbacks = []
        with self._lock:
            coll = self._colls.get(cid)
            if coll is None:
                raise KeyError(f"no collection {cid}")
            for t in txns:
                for op in t.ops:
                    self._apply(coll, op)
                callbacks.extend(t.on_commit)
        for cb in callbacks:
            cb()

    def _obj(self, coll, oid) -> _Object:
        o = coll.get(oid)
        if o is None:
            o = coll[oid] = _Object()
        return o

    def _apply(self, coll, op) -> None:
        if isinstance(op, os_.OpTouch):
            self._obj(coll, op.oid)
        elif isinstance(op, os_.OpWrite):
            o = self._obj(coll, op.oid)
            end = op.offset + op.data.size
            if len(o.data) < end:
                o.data.extend(bytes(end - len(o.data)))
            o.data[op.offset:end] = op.data.tobytes()
        elif isinstance(op, os_.OpZero):
            o = self._obj(coll, op.oid)
            end = op.offset + op.length
            if len(o.data) < end:
                o.data.extend(bytes(end - len(o.data)))
            o.data[op.offset:end] = bytes(op.length)
        elif isinstance(op, os_.OpTruncate):
            o = self._obj(coll, op.oid)
            if op.size < len(o.data):
                del o.data[op.size:]
            else:
                o.data.extend(bytes(op.size - len(o.data)))
        elif isinstance(op, os_.OpRemove):
            coll.pop(op.oid, None)
        elif isinstance(op, os_.OpSetAttrs):
            self._obj(coll, op.oid).xattrs.update(op.attrs)
        elif isinstance(op, os_.OpRmAttr):
            self._obj(coll, op.oid).xattrs.pop(op.name, None)
        elif isinstance(op, os_.OpClone):
            src = coll.get(op.src)
            if src is not None:
                coll[op.dst] = src.clone()
        elif isinstance(op, os_.OpRename):
            src = coll.pop(op.src, None)
            if src is not None:
                coll[op.dst] = src
        elif isinstance(op, os_.OpOmapSet):
            self._obj(coll, op.oid).omap.update(op.kv)
        elif isinstance(op, os_.OpOmapRmKeys):
            o = self._obj(coll, op.oid)
            for k in op.keys:
                o.omap.pop(k, None)
        elif isinstance(op, os_.OpOmapClear):
            o = self._obj(coll, op.oid)
            o.omap.clear()
            o.omap_header = b""
        elif isinstance(op, os_.OpOmapSetHeader):
            self._obj(coll, op.oid).omap_header = op.data
        else:
            raise TypeError(f"unknown transaction op {op!r}")

    # -- reads --------------------------------------------------------------

    def _get(self, cid, oid) -> _Object:
        coll = self._colls.get(cid)
        if coll is None:
            raise KeyError(f"no collection {cid}")
        o = coll.get(oid)
        if o is None:
            raise KeyError(f"no object {oid} in {cid}")
        return o

    def read(self, cid, oid, offset=0, length=None) -> np.ndarray:
        with self._lock:
            o = self._get(cid, oid)
            end = len(o.data) if length is None else min(
                len(o.data), offset + length)
            return np.frombuffer(bytes(o.data[offset:end]), dtype=np.uint8)

    def stat(self, cid, oid) -> int:
        with self._lock:
            return len(self._get(cid, oid).data)

    def exists(self, cid, oid) -> bool:
        with self._lock:
            coll = self._colls.get(cid)
            return coll is not None and oid in coll

    def getattr(self, cid, oid, name) -> bytes:
        with self._lock:
            return self._get(cid, oid).xattrs[name]

    def getattrs(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).xattrs)

    def omap_get(self, cid, oid) -> dict[bytes, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).omap)

    def omap_get_header(self, cid, oid) -> bytes:
        with self._lock:
            return self._get(cid, oid).omap_header

    def list_objects(self, cid) -> list[ghobject_t]:
        with self._lock:
            coll = self._colls.get(cid)
            if coll is None:
                raise KeyError(f"no collection {cid}")
            return sorted(coll)

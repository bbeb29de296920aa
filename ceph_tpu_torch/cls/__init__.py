"""Object classes: server-side compute on objects (reference
src/objclass/, src/cls/, osd/ClassHandler.{h,cc}).

The reference dlopens cls_*.so plugins into the OSD and dispatches
CEPH_OSD_OP_CALL from do_osd_ops (PrimaryLogPG.cc:5643) into their
registered methods.  Here classes are python modules registered with
`register_class`; a method is fn(ctx, input: bytes) -> bytes (raising
ClsError(errno) to fail the op).  The ctx exposes the object the op
targets — read, write, xattrs — through the owning PG backend, so class
methods compose with EC pools exactly like client I/O does.

Built-ins: `lock` (advisory locks, reference cls_lock), `numops`
(atomic u64 arithmetic, reference cls_numops), `refcount`
(reference cls_refcount).
"""

from __future__ import annotations

import errno
from typing import Callable

Method = Callable[["ClsContext", bytes], bytes]


class ClsError(Exception):
    def __init__(self, err: int, msg: str = ""):
        super().__init__(msg or errno.errorcode.get(err, str(err)))
        self.errno = err


_CLASSES: dict[str, dict[str, Method]] = {}


def register_class(name: str, methods: dict[str, Method]) -> None:
    _CLASSES[name] = dict(methods)


def get_method(cls_name: str, method: str) -> Method | None:
    return _CLASSES.get(cls_name, {}).get(method)


def list_classes() -> dict[str, list[str]]:
    return {c: sorted(m) for c, m in _CLASSES.items()}


class ClsContext:
    """Execution context handed to class methods (reference cls_method
    call context + cls_cxx_read/write/getxattr/setxattr)."""

    def __init__(self, daemon, state, pgid, oid):
        self.daemon = daemon
        self.state = state
        self.pgid = pgid
        self.oid = oid
        self._pending_attrs: dict[str, bytes | None] = {}
        self._pending_write: tuple[int, bytes] | None = None

    # -- reads --------------------------------------------------------------

    def read(self, off: int = 0, length: int | None = None) -> bytes:
        import numpy as np
        be = self.state.backend
        data = be.read(self.oid, off, length)
        return np.asarray(data).tobytes() if data is not None else b""

    def getxattr(self, name: str) -> bytes | None:
        if name in self._pending_attrs:
            return self._pending_attrs[name]
        if self.state.kind == "ec":
            be = self.state.backend
            for s in range(be.n):
                reply = getattr(be.shards, "_stat_rpc", None)
                if reply is not None:
                    r = be.shards._stat_rpc(s, self.oid, True)
                    if r is not None and r.result == 0:
                        return r.attrs.get(name)
                    continue
                # local backend: direct store access
                from ..osd.ec_transaction import shard_oid
                try:
                    return be.shards.store.getattr(
                        be.shards.cids[s], shard_oid(self.oid, s), name)
                except KeyError:
                    return None
        else:
            from ..osd.types import NO_SHARD, ghobject_t, spg_t
            try:
                return self.daemon.store.getattr(
                    self.daemon._cid(spg_t(self.pgid, NO_SHARD)),
                    ghobject_t(self.oid, shard=NO_SHARD), name)
            except KeyError:
                return None
        return None

    # -- staged mutations (committed as one PGTransaction) ------------------

    def setxattr(self, name: str, value: bytes) -> None:
        self._pending_attrs[name] = bytes(value)

    def rmxattr(self, name: str) -> None:
        self._pending_attrs[name] = None

    def write_full(self, data: bytes) -> None:
        self._pending_write = (0, bytes(data))

    def has_mutations(self) -> bool:
        return bool(self._pending_attrs) or self._pending_write is not None


# -- built-in classes --------------------------------------------------------

from . import (cls_journal, cls_lock, cls_log,  # noqa: E402,F401
               cls_numops, cls_refcount, cls_rgw, cls_user)

"""cls_lock: advisory object locks (reference src/cls/lock/).

Lock state lives in a JSON xattr; methods: lock (exclusive|shared),
unlock, break_lock, get_info.  Input/output are JSON bytes.
"""

from __future__ import annotations

import errno
import json

from . import ClsContext, ClsError, register_class

ATTR = "cls_lock.state"


def _load(ctx: ClsContext) -> dict:
    raw = ctx.getxattr(ATTR)
    return json.loads(raw.decode()) if raw else {"lockers": {},
                                                 "type": None}


def _store(ctx: ClsContext, st: dict) -> None:
    ctx.setxattr(ATTR, json.dumps(st).encode())


def lock(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    name, owner = req["name"], req["owner"]
    ltype = req.get("type", "exclusive")
    st = _load(ctx)
    lockers = st["lockers"]
    if lockers:
        if st["type"] == "exclusive" or ltype == "exclusive":
            if owner not in lockers:
                raise ClsError(errno.EBUSY, "locked")
    # the locker's messenger entity rides the record (reference
    # cls_lock stores the locker's addr/cookie) so a steal can
    # blacklist the old owner at the OSDs before breaking the lock
    lockers[owner] = {"name": name, "type": ltype,
                      "entity": req.get("entity")}
    st["type"] = ltype
    _store(ctx, st)
    return b"{}"


def unlock(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    st = _load(ctx)
    if req["owner"] not in st["lockers"]:
        raise ClsError(errno.ENOENT, "not locked by owner")
    del st["lockers"][req["owner"]]
    if not st["lockers"]:
        st["type"] = None
    _store(ctx, st)
    return b"{}"


def break_lock(ctx: ClsContext, inp: bytes) -> bytes:
    st = _load(ctx)
    st["lockers"] = {}
    st["type"] = None
    _store(ctx, st)
    return b"{}"


def get_info(ctx: ClsContext, inp: bytes) -> bytes:
    return json.dumps(_load(ctx)).encode()


register_class("lock", {
    "lock": lock, "unlock": unlock,
    "break_lock": break_lock, "get_info": get_info,
})

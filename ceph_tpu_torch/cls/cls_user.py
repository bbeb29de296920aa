"""cls_user-role: per-user account object class.

Re-expresses the slice of reference src/cls/user/cls_user.cc RGW
consumes: a user header object holding per-bucket usage stats
(entries, bytes) updated server-side as bucket indexes change, plus
quota fields — the data the reference's RGWQuotaHandler reads before
admitting writes (src/rgw/rgw_quota.cc).

Layout: {"buckets": {bucket: {"objects": int, "bytes": int}},
"quota": {"max_objects": int|-1, "max_bytes": int|-1},
"pending": {token: {"objects": int, "bytes": int, "ts": float}}}.

The "pending" map backs reserve/release: quota admission is a
server-side reservation in the SAME atomic class call that checks the
totals, so two writers racing the last quota slot — from any process
or host — serialize on the user object and exactly one wins (the
reference serializes admission in RGWQuotaHandler against cached
stats; here the OSD's per-object CALL serialization is the lock).
Reservations carry a TTL so a crashed writer's reservation expires
instead of leaking quota."""

from __future__ import annotations

import errno
import json
import time
import uuid

from . import ClsError, register_class


def _load(ctx) -> dict:
    raw = ctx.read()
    if not raw:
        return {"buckets": {}, "quota": {"max_objects": -1,
                                         "max_bytes": -1}}
    try:
        return json.loads(raw.decode())
    except ValueError as e:
        raise ClsError(5, f"corrupt user object: {e}") from e


def _store(ctx, d: dict) -> None:
    ctx.write_full(json.dumps(d, separators=(",", ":")).encode())


def add_stats(ctx, inp: bytes) -> bytes:
    """input: {"bucket": str, "objects": +/-int, "bytes": +/-int} —
    atomic server-side delta (reference cls_user_add_bucket /
    cls_user_update_buckets)."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    b = d["buckets"].setdefault(req["bucket"],
                                {"objects": 0, "bytes": 0})
    b["objects"] = max(0, b["objects"] + int(req.get("objects", 0)))
    b["bytes"] = max(0, b["bytes"] + int(req.get("bytes", 0)))
    _store(ctx, d)
    return b""


def rm_bucket(ctx, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    d = _load(ctx)
    d["buckets"].pop(req["bucket"], None)
    _store(ctx, d)
    return b""


def get_header(ctx, _inp: bytes) -> bytes:
    """-> the whole user record incl. totals."""
    d = _load(ctx)
    totals = {"objects": sum(b["objects"]
                             for b in d["buckets"].values()),
              "bytes": sum(b["bytes"] for b in d["buckets"].values())}
    return json.dumps({**d, "totals": totals}).encode()


def set_quota(ctx, inp: bytes) -> bytes:
    """input: {"max_objects": int|-1, "max_bytes": int|-1} (-1 =
    unlimited)."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    for k in ("max_objects", "max_bytes"):
        if k in req:
            d["quota"][k] = int(req[k])
    _store(ctx, d)
    return b""


def _purge_pending(d: dict, now: float, ttl: float) -> None:
    pend = d.get("pending")
    if not pend:
        return
    dead = [t for t, p in pend.items()
            if now - float(p.get("ts", 0.0)) > ttl]
    for t in dead:
        del pend[t]
    if not pend:
        d.pop("pending", None)


def reserve(ctx, inp: bytes) -> bytes:
    """input: {"objects": +/-int, "bytes": +/-int, "ttl": float} —
    check quota against committed totals PLUS live reservations and,
    if it fits, record a reservation; -> {"token": str}.  Raises
    EDQUOT when the delta would exceed either limit.  Negative deltas
    (shrinking overwrite, delete) always admit — freeing space must
    never be blocked by quota."""
    req = json.loads(inp.decode())
    d_obj = int(req.get("objects", 0))
    d_bytes = int(req.get("bytes", 0))
    ttl = float(req.get("ttl", 30.0))
    d = _load(ctx)
    now = time.time()
    _purge_pending(d, now, ttl)
    if d_obj > 0 or d_bytes > 0:
        q = d.get("quota", {})
        max_o = int(q.get("max_objects", -1))
        max_b = int(q.get("max_bytes", -1))
        pend = d.get("pending", {})
        cur_o = (sum(b["objects"] for b in d["buckets"].values())
                 + sum(int(p.get("objects", 0)) for p in pend.values()))
        cur_b = (sum(b["bytes"] for b in d["buckets"].values())
                 + sum(int(p.get("bytes", 0)) for p in pend.values()))
        if max_o >= 0 and d_obj > 0 and cur_o + d_obj > max_o:
            raise ClsError(errno.EDQUOT, "object quota exceeded")
        if max_b >= 0 and d_bytes > 0 and cur_b + d_bytes > max_b:
            raise ClsError(errno.EDQUOT, "byte quota exceeded")
    token = uuid.uuid4().hex
    d.setdefault("pending", {})[token] = {
        "objects": d_obj, "bytes": d_bytes, "ts": now}
    _store(ctx, d)
    return json.dumps({"token": token}).encode()


def release(ctx, inp: bytes) -> bytes:
    """input: {"token": str} — drop a reservation (the write either
    committed its real delta via add_stats or aborted).  Unknown
    tokens are fine: the reservation may have TTL-expired."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    pend = d.get("pending")
    if pend and pend.pop(req.get("token", ""), None) is not None:
        if not pend:
            d.pop("pending", None)
        _store(ctx, d)
    return b""


register_class("user", {
    "add_stats": add_stats,
    "rm_bucket": rm_bucket,
    "get_header": get_header,
    "set_quota": set_quota,
    "reserve": reserve,
    "release": release,
})

"""cls_journal-role: ordered, trimmable event log object class.

Re-expresses the slice of reference src/cls/journal/cls_journal.cc the
framework's log consumers need: a journal header object the OSD mutates
server-side, so appends allocate sequence numbers atomically, clients
(replayers/mirrors) register commit positions on the journal itself,
and trim is fenced by the slowest registered client (reference
cls::journal::client::committed + set_minimum_set).

Consumers: the RGW multisite mod-log (rgw/sync.py) and the RBD image
journal (rbd/journal.py) — the same seam the reference routes both
through.

Layout (one JSON doc in the object body, like the other cls modules —
see cls_rgw.py's idiomatic-shift note): {"next": int, "entries":
{"%016x": entry}, "clients": {id: pos}}.
"""

from __future__ import annotations

import json

from . import ClsError, register_class


def _load(ctx) -> dict:
    raw = ctx.read()
    if not raw:
        return {"next": 0, "entries": {}, "clients": {}}
    try:
        return json.loads(raw.decode())
    except ValueError as e:
        raise ClsError(5, f"corrupt journal: {e}") from e


def _store(ctx, d: dict) -> None:
    ctx.write_full(json.dumps(d, separators=(",", ":")).encode())


def create(ctx, _inp: bytes) -> bytes:
    if not ctx.read():
        _store(ctx, {"next": 0, "entries": {}, "clients": {}})
    return b""


def append(ctx, inp: bytes) -> bytes:
    """input: {"entry": {...}} -> seq (decimal).  Seq allocation and
    entry store are one server-side mutation: concurrent writers can
    never collide (reference cls_journal guard_append/append)."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    seq = int(d["next"])
    d["entries"][f"{seq:016x}"] = req["entry"]
    d["next"] = seq + 1
    _store(ctx, d)
    return str(seq).encode()


def list_entries(ctx, inp: bytes) -> bytes:
    """input: {"after_seq": int, "max": int} -> {"entries":
    [[seq, entry]...], "truncated": bool} in seq order."""
    req = json.loads(inp.decode()) if inp else {}
    after = int(req.get("after_seq", -1))
    limit = int(req.get("max", 256))
    d = _load(ctx)
    keys = sorted(k for k in d["entries"] if int(k, 16) > after)
    out = [[int(k, 16), d["entries"][k]] for k in keys[:limit]]
    return json.dumps({"entries": out,
                       "truncated": len(keys) > limit}).encode()


def client_register(ctx, inp: bytes) -> bytes:
    """input: {"id": str, "pos": int} — idempotent; an existing
    client keeps its position (a restarted replayer must resume, not
    reset)."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    d["clients"].setdefault(req["id"], int(req.get("pos", -1)))
    _store(ctx, d)
    return b""


def client_update(ctx, inp: bytes) -> bytes:
    """input: {"id": str, "pos": int} — commit position only moves
    forward (an old in-flight update must not rewind a newer one)."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    if req["id"] not in d["clients"]:
        raise ClsError(2, f"no such client {req['id']!r}")
    d["clients"][req["id"]] = max(int(d["clients"][req["id"]]),
                                  int(req["pos"]))
    _store(ctx, d)
    return b""


def client_get(ctx, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    d = _load(ctx)
    if req["id"] not in d["clients"]:
        raise ClsError(2, f"no such client {req['id']!r}")
    return json.dumps({"pos": d["clients"][req["id"]]}).encode()


def client_list(ctx, _inp: bytes) -> bytes:
    return json.dumps(_load(ctx)["clients"]).encode()


def client_unregister(ctx, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    d = _load(ctx)
    d["clients"].pop(req["id"], None)
    _store(ctx, d)
    return b""


def trim(ctx, inp: bytes) -> bytes:
    """input: {"to_seq": int} — drop entries <= to_seq.  Fenced by the
    slowest registered client: trimming past an unconsumed entry is
    refused (reference set_minimum_set fencing)."""
    req = json.loads(inp.decode())
    to_seq = int(req["to_seq"])
    d = _load(ctx)
    if d["clients"]:
        floor = min(int(p) for p in d["clients"].values())
        if to_seq > floor:
            raise ClsError(22, f"trim {to_seq} past slowest client "
                               f"position {floor}")
    d["entries"] = {k: v for k, v in d["entries"].items()
                    if int(k, 16) > to_seq}
    _store(ctx, d)
    return b""


register_class("journal", {
    "create": create,
    "append": append,
    "list": list_entries,
    "client_register": client_register,
    "client_update": client_update,
    "client_get": client_get,
    "client_list": client_list,
    "client_unregister": client_unregister,
    "trim": trim,
})

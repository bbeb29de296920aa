"""cls_log-role: timestamped log object class.

Re-expresses the slice of reference src/cls/log/cls_log.cc its in-repo
consumer needs (the RGW usage/ops log, reference rgw_usage.cc rides
cls_log the same way): server-side appends keyed by timestamp+counter,
time-range listing with pagination, and time-bounded trim.

Layout (one JSON doc in the body, like the other cls modules):
{"next": int, "entries": {"%016.6f_%08d": entry}}.
"""

from __future__ import annotations

import json

from . import ClsError, register_class


def _load(ctx) -> dict:
    raw = ctx.read()
    if not raw:
        return {"next": 0, "entries": {}}
    try:
        return json.loads(raw.decode())
    except ValueError as e:
        raise ClsError(5, f"corrupt log object: {e}") from e


def _store(ctx, d: dict) -> None:
    ctx.write_full(json.dumps(d, separators=(",", ":")).encode())


def _key(ts: float, n: int) -> str:
    return f"{ts:016.6f}_{n:08d}"


def add(ctx, inp: bytes) -> bytes:
    """input: {"ts": float, "entry": {...}} (or a list under
    "entries").  Key = timestamp + server-side counter: same-timestamp
    appends never collide (reference cls_log add with sub-second
    uniquifier)."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    ents = req.get("entries")
    if ents is None:
        ents = [{"ts": req["ts"], "entry": req["entry"]}]
    for e in ents:
        n = int(d["next"])
        d["entries"][_key(float(e["ts"]), n)] = e["entry"]
        d["next"] = n + 1
    _store(ctx, d)
    return b""


def list_entries(ctx, inp: bytes) -> bytes:
    """input: {"from_ts": float, "to_ts": float, "marker": str,
    "max": int} -> {"entries": [[key, ts, entry]...], "truncated":
    bool, "marker": str} in time order."""
    req = json.loads(inp.decode()) if inp else {}
    from_ts = float(req.get("from_ts", 0.0))
    to_ts = float(req.get("to_ts", 1e18))
    marker = req.get("marker", "")
    limit = int(req.get("max", 256))
    d = _load(ctx)
    keys = sorted(k for k in d["entries"]
                  if k > marker and
                  from_ts <= float(k.split("_")[0]) < to_ts)
    page = keys[:limit]
    return json.dumps({
        "entries": [[k, float(k.split("_")[0]), d["entries"][k]]
                    for k in page],
        "truncated": len(keys) > limit,
        "marker": page[-1] if page else marker}).encode()


def trim(ctx, inp: bytes) -> bytes:
    """input: {"to_ts": float} — drop entries with ts < to_ts."""
    req = json.loads(inp.decode())
    to_ts = float(req["to_ts"])
    d = _load(ctx)
    d["entries"] = {k: v for k, v in d["entries"].items()
                    if float(k.split("_")[0]) >= to_ts}
    _store(ctx, d)
    return b""


register_class("log", {
    "add": add,
    "list": list_entries,
    "trim": trim,
})

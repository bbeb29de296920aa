"""cls_rgw-role: the bucket directory object class.

Re-expresses the slice of reference src/cls/rgw/cls_rgw.cc the gateway
needs: the bucket index lives in a directory object the OSD mutates
server-side, so index updates are atomic with respect to each other
(reference cls_rgw_bucket_dir_entry + rgw_bucket_dir ops; the OSD
serializes CALL ops per object).

Idiomatic shift: the reference keeps one omap row per entry; here the
directory is a JSON document in the object body (this build's EC/
replicated PGTransaction does not carry omap — and the reference also
restricts omap to replicated pools, so index pools are small-metadata
pools either way).  The op surface (add/rm/list with prefix+marker
pagination) is the same.

Reserved doc keys: "@next" (log_append's sequence row) and
"@tombstones" (reshard dual-write deletion intents, see dir_rm /
dir_merge).  "@tombstones" is excluded from dir_list/dir_count; the
planes that shard (index/versions) never store user rows named
"@tombstones" (S3 keys can technically start with "@", but the exact
string "@tombstones" colliding is a documented deviation, accepted
for the same reason reference cls_rgw reserves its BI_PREFIX_CHAR
namespace).
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict

from . import ClsError, register_class

# Parsed-doc cache: directory docs are read-modify-written whole, so
# without it every dir op re-parses the full JSON doc — O(doc) per
# call, which makes a LIST PAGE cost grow with bucket size instead of
# page size.  Keyed per (daemon, oid) and guarded by a digest of the
# raw bytes: any out-of-band change to the object (recovery adoption,
# another primary after an interval change, a failed commit) just
# misses and re-parses, so the cache can never serve a stale doc.
# Entries hand out COPIES (top level + the "@tombstones" row, the
# only nested dict methods mutate in place): per-object call
# serialization protects the doc a method mutates, but a cached dict
# shared across calls would not survive concurrent dir_list readers.
# Per-entry meta dicts are shared — every method replaces them whole,
# never edits them.
_DOC_CACHE_MAX = 64
_doc_cache: OrderedDict = OrderedDict()
_doc_mu = threading.Lock()


def _cache_key(ctx) -> tuple:
    return (id(ctx.daemon), getattr(ctx.oid, "name", str(ctx.oid)))


def _copy_doc(d: dict) -> dict:
    c = dict(d)
    ts = c.get("@tombstones")
    if ts is not None:
        c["@tombstones"] = dict(ts)
    return c


def _cache_put(key: tuple, dig: bytes, d: dict) -> None:
    with _doc_mu:
        _doc_cache[key] = (dig, _copy_doc(d))
        _doc_cache.move_to_end(key)
        while len(_doc_cache) > _DOC_CACHE_MAX:
            _doc_cache.popitem(last=False)


def _load(ctx) -> dict:
    raw = ctx.read()
    if not raw:
        return {}
    key = _cache_key(ctx)
    dig = hashlib.md5(raw).digest()
    with _doc_mu:
        hit = _doc_cache.get(key)
        if hit is not None and hit[0] == dig:
            _doc_cache.move_to_end(key)
            return _copy_doc(hit[1])
    try:
        d = json.loads(raw.decode())
    except ValueError as e:
        raise ClsError(5, f"corrupt bucket dir: {e}") from e
    _cache_put(key, dig, d)
    return d


def _store(ctx, d: dict) -> None:
    raw = json.dumps(d, separators=(",", ":")).encode()
    ctx.write_full(raw)
    # cache the post-write doc under the bytes being committed; if
    # the transaction never lands, the next read's digest misses
    _cache_put(_cache_key(ctx), hashlib.md5(raw).digest(), d)


def dir_init(ctx, _inp: bytes) -> bytes:
    if not ctx.read():
        _store(ctx, {})
    return b""


def dir_add(ctx, inp: bytes) -> bytes:
    """input: {"key": str, "meta": {...}} — upsert one entry.  A
    re-add supersedes any reshard tombstone for the key (the put
    happened after the delete in this shard's serial order)."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    d[req["key"]] = req.get("meta", {})
    ts = d.get("@tombstones")
    if ts and ts.pop(req["key"], None) is not None and not ts:
        del d["@tombstones"]
    _store(ctx, d)
    return b""


def dir_rm(ctx, inp: bytes) -> bytes:
    """input: {"key": str, "tombstone": bool?}.  Plain rm errors on a
    missing key (ENOENT).  tombstone mode is the reshard dual-write
    delete: it never errors and records the deletion intent under
    "@tombstones" so a later dir_merge if_absent copy of a stale entry
    from the old shard set cannot resurrect the key."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    if req.get("tombstone"):
        d.pop(req["key"], None)
        d.setdefault("@tombstones", {})[req["key"]] = 1
        _store(ctx, d)
        return b""
    if req["key"] not in d:
        raise ClsError(2, "no such key")
    del d[req["key"]]
    _store(ctx, d)
    return b""


def dir_merge(ctx, inp: bytes) -> bytes:
    """input: {"entries": [[key, meta]...], "if_absent": bool} — batch
    upsert, one atomic class call per page (the resharder's copy op).
    if_absent skips keys already present OR tombstoned: a dual-write
    that landed on the new shard first (newer data, or a delete) must
    win over the copier's snapshot of the old shard.  -> number of
    entries applied."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    if_absent = bool(req.get("if_absent"))
    ts = d.get("@tombstones", {})
    applied = 0
    for k, meta in req.get("entries", []):
        if if_absent and (k in d or k in ts):
            continue
        d[k] = meta
        applied += 1
    if applied:
        _store(ctx, d)
    return str(applied).encode()


def dir_reshard_clean(ctx, _inp: bytes) -> bytes:
    """Drop the "@tombstones" row after reshard cutover (old shards
    reaped; nothing left to merge against)."""
    d = _load(ctx)
    if d.pop("@tombstones", None) is not None:
        _store(ctx, d)
    return b""


def dir_get(ctx, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    d = _load(ctx)
    ent = d.get(req["key"])
    if ent is None:
        raise ClsError(2, "no such key")
    return json.dumps(ent).encode()


def dir_list(ctx, inp: bytes) -> bytes:
    """input: {"prefix": str, "marker": str, "from": str, "max": int}
    -> {"entries": [[key, meta]...], "truncated": bool} in key order
    (reference rgw_bucket_dir list with pagination).  "marker" is an
    EXCLUSIVE lower bound (keys > marker); "from" is INCLUSIVE (keys
    >= from) — delimiter pagination resumes at a computed successor
    that must not itself be skippable."""
    req = json.loads(inp.decode()) if inp else {}
    prefix = req.get("prefix", "")
    marker = req.get("marker", "")
    resume = req.get("from", "")
    limit = int(req.get("max", 1000))
    d = _load(ctx)
    keys = sorted(k for k in d
                  if k != "@tombstones"
                  and k.startswith(prefix) and k > marker
                  and (not resume or k >= resume))
    out = [[k, d[k]] for k in keys[:limit]]
    return json.dumps({"entries": out,
                       "truncated": len(keys) > limit}).encode()


def dir_count(ctx, _inp: bytes) -> bytes:
    d = _load(ctx)
    return str(len(d) - ("@tombstones" in d)).encode()


def log_append(ctx, inp: bytes) -> bytes:
    """Append with server-side sequence allocation: the "@next" meta
    row is read+bumped in the same atomic class call, so concurrent
    writers can never collide on a sequence number (journal role;
    reference journal object append exclusivity)."""
    req = json.loads(inp.decode())
    d = _load(ctx)
    seq = int(d.get("@next", {}).get("seq", 0))
    d[f"{seq:016x}"] = req.get("meta", {})
    d["@next"] = {"seq": seq + 1}
    _store(ctx, d)
    return str(seq).encode()


register_class("rgw", {
    "dir_init": dir_init,
    "dir_add": dir_add,
    "dir_rm": dir_rm,
    "dir_merge": dir_merge,
    "dir_reshard_clean": dir_reshard_clean,
    "dir_get": dir_get,
    "dir_list": dir_list,
    "dir_count": dir_count,
    "log_append": log_append,
})

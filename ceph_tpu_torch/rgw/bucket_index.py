"""Sharded bucket index plane (reference RGWBucketInfo layout +
cls_rgw bucket index shards).

The reference spreads a bucket's index over N rados objects
(".dir.<marker>.<shard>"), routing each key by a stable hash —
rgw_bucket_shard_index of src/rgw/rgw_common.cc — so index write load
scales with shard count and no single directory object becomes a
serialization point.  This module re-expresses that plane:

- layout: bucket meta carries {"index": {"shards": N, "gen": G}};
  absent means the legacy single object ("index.<bucket>",
  "versions.<bucket>") written by older builds — those buckets keep
  working unchanged.  Sharded planes live at
  "index.<bucket>.g<gen>.<i>"; the generation bumps on every reshard
  so old and new shard sets never collide.
- routing: shard_of() hashes the S3 key (md5, stable across processes
  and runs — never Python's randomized hash()).  The VERSION plane
  shards by the PARENT key, not the row key, so every version row of
  one key lands in one shard and per-key newest-first adjacency (the
  inverted-timestamp version ids) survives sharding.
- dual-write: while bucket meta carries a {"reshard": {...,"state":
  "dual"}} marker, every mutation lands on the OLD layout (still
  authoritative, reads come from it) AND the NEW one; deletes
  tombstone on the new side so the reshard copier cannot resurrect a
  key it copies after the delete (see cls_rgw dir_merge/if_absent).
- listing: _MergedCursor k-way-merges per-shard dir_list pages with
  an independent cursor per shard — one bounded page per shard in
  flight, so a listing costs O(shards) pages, not O(keys).

Per-shard put/list counters accumulate in-process (dynamic key space;
surfaced through `bucket limit check` and the s3-shard-sweep harness
gate rather than the pre-declared PerfCounters schema).
"""

from __future__ import annotations

import hashlib
import json
import threading

from ..rados.client import RadosError


def shard_of(key: str, nshards: int) -> int:
    """Stable key->shard routing (reference rgw_bucket_shard_index).
    md5 rather than hash(): routing must agree across processes,
    restarts, and PYTHONHASHSEED — a disagreement misroutes keys."""
    if nshards <= 1:
        return 0
    h = hashlib.md5(key.encode("utf-8", "surrogatepass")).digest()
    return int.from_bytes(h[:4], "big") % nshards


class _Layout:
    """One concrete shard set of one bucket's index generation."""

    __slots__ = ("bucket", "shards", "gen")

    def __init__(self, bucket: str, shards: int, gen: int):
        self.bucket = bucket
        self.shards = int(shards)
        self.gen = int(gen)

    def oid(self, plane: str, shard: int) -> str:
        # legacy single-object layout spells exactly the old oid so
        # pre-shard buckets (and tests poking "index.<bucket>"
        # directly) are untouched
        if self.gen == 0 and self.shards == 1:
            return f"{plane}.{self.bucket}"
        return f"{plane}.{self.bucket}.g{self.gen}.{shard}"

    def oids(self, plane: str) -> list[str]:
        return [self.oid(plane, i) for i in range(self.shards)]

    def shard_oid(self, plane: str, key: str) -> str:
        return self.oid(plane, shard_of(key, self.shards))

    @staticmethod
    def from_bmeta(bucket: str, bmeta: dict | None) -> "_Layout":
        idx = (bmeta or {}).get("index")
        if not idx:
            return _Layout(bucket, 1, 0)
        return _Layout(bucket, idx.get("shards", 1), idx.get("gen", 0))

    @staticmethod
    def reshard_target(bucket: str, bmeta: dict | None
                       ) -> "_Layout | None":
        rs = (bmeta or {}).get("reshard")
        if not rs or rs.get("state") != "dual":
            return None
        return _Layout(bucket, rs["shards"], rs["gen"])


class BucketIndex:
    """Shard-routing facade the store funnels every index/versions
    plane access through.  Owns layout resolution (bucket meta),
    dual-write fan-out during reshard, cross-shard count/list, and
    the per-shard op counters."""

    def __init__(self, store):
        self.store = store
        self._mu = threading.Lock()
        # {(bucket, plane, shard_oid): {"put": n, "rm": n, "get": n,
        #  "list": n}}
        self._counters: dict[tuple, dict] = {}

    # -- plumbing ----------------------------------------------------

    def _cls(self, oid: str, method: str,
             payload: dict | None = None) -> bytes:
        return self.store._cls(self.store.meta, oid, method, payload)

    def _count(self, bucket: str, plane: str, oid: str,
               op: str, n: int = 1) -> None:
        with self._mu:
            c = self._counters.setdefault(
                (bucket, plane, oid),
                {"put": 0, "rm": 0, "get": 0, "list": 0})
            c[op] += n

    def perf_dump(self, bucket: str | None = None) -> dict:
        """{plane_oid: {put, rm, get, list}} — per-shard op totals."""
        with self._mu:
            return {oid: dict(c)
                    for (b, _pl, oid), c in self._counters.items()
                    if bucket is None or b == bucket}

    def _bmeta(self, bucket: str, bmeta: dict | None) -> dict | None:
        if bmeta is not None:
            return bmeta
        return self.store._bucket_meta(bucket)

    def _write_layouts(self, bucket: str, bmeta: dict | None
                       ) -> list[_Layout]:
        """Old layout first (authoritative), reshard target second."""
        bmeta = self._bmeta(bucket, bmeta)
        out = [_Layout.from_bmeta(bucket, bmeta)]
        tgt = _Layout.reshard_target(bucket, bmeta)
        if tgt is not None:
            out.append(tgt)
        return out

    def read_layout(self, bucket: str,
                    bmeta: dict | None = None) -> _Layout:
        return _Layout.from_bmeta(bucket, self._bmeta(bucket, bmeta))

    # -- mutations (dual-write aware) --------------------------------

    def init(self, bucket: str, shards: int = 1, gen: int = 0) -> None:
        lay = _Layout(bucket, shards, gen)
        for oid in lay.oids("index"):
            self._cls(oid, "dir_init")

    def add(self, bucket: str, plane: str, key: str, meta: dict,
            route: str | None = None,
            bmeta: dict | None = None) -> None:
        """Upsert one entry; `route` overrides the routing key (the
        versions plane routes by parent key, writes the row key)."""
        rk = key if route is None else route
        layouts = self._write_layouts(bucket, bmeta)
        for lay in layouts:
            oid = lay.shard_oid(plane, rk)
            self._cls(oid, "dir_add", {"key": key, "meta": meta})
            self._count(bucket, plane, oid, "put")
        self.store._drop_cursors(bucket)

    def rm(self, bucket: str, plane: str, key: str,
           route: str | None = None,
           bmeta: dict | None = None) -> None:
        """Remove one entry.  Raises RadosError(ENOENT) per the OLD
        (authoritative) layout; the reshard-target copy is a tombstone
        write that never errors — during dual-write the new shard may
        legitimately not hold the key yet, but the deletion intent
        must be recorded so the copier cannot resurrect it."""
        rk = key if route is None else route
        layouts = self._write_layouts(bucket, bmeta)
        old, rest = layouts[0], layouts[1:]
        for lay in rest:
            oid = lay.shard_oid(plane, rk)
            self._cls(oid, "dir_rm", {"key": key, "tombstone": True})
            self._count(bucket, plane, oid, "rm")
        oid = old.shard_oid(plane, rk)
        self._cls(oid, "dir_rm", {"key": key})
        self._count(bucket, plane, oid, "rm")
        self.store._drop_cursors(bucket)

    # -- reads (old layout is authoritative until cutover) -----------

    def get(self, bucket: str, plane: str, key: str,
            route: str | None = None,
            bmeta: dict | None = None) -> bytes:
        rk = key if route is None else route
        lay = self.read_layout(bucket, bmeta)
        oid = lay.shard_oid(plane, rk)
        self._count(bucket, plane, oid, "get")
        return self._cls(oid, "dir_get", {"key": key})

    def count(self, bucket: str, plane: str = "index",
              bmeta: dict | None = None) -> int:
        """Entry count summed across shards (reference: per-shard
        header stats summed by bucket stats)."""
        lay = self.read_layout(bucket, bmeta)
        total = 0
        for oid in lay.oids(plane):
            try:
                total += int(self._cls(oid, "dir_count"))
            except RadosError as e:
                self.store._not_found(e)
        return total

    def shard_counts(self, bucket: str, plane: str = "index",
                     bmeta: dict | None = None) -> dict[str, int]:
        """{shard_oid: entries} — the `bucket limit check` fill view."""
        lay = self.read_layout(bucket, bmeta)
        out = {}
        for oid in lay.oids(plane):
            try:
                out[oid] = int(self._cls(oid, "dir_count"))
            except RadosError as e:
                self.store._not_found(e)
                out[oid] = 0
        return out

    def cursor(self, bucket: str, plane: str, prefix: str = "",
               marker: str = "", resume: str = "",
               page: int = 1000, bmeta: dict | None = None,
               lay: "_Layout | None" = None) -> "_MergedCursor":
        if lay is None:
            lay = self.read_layout(bucket, bmeta)
        for oid in lay.oids(plane):
            self._count(bucket, plane, oid, "list")
        return _MergedCursor(self, lay.oids(plane), prefix, marker,
                             resume, page)

    def remove_all(self, bucket: str, bmeta: dict | None = None
                   ) -> None:
        """Reap every shard object of every plane (bucket deletion);
        covers an in-flight reshard target too."""
        for lay in self._write_layouts(bucket, bmeta):
            for plane in ("index", "versions"):
                for oid in lay.oids(plane):
                    try:
                        self.store.meta.remove(oid)
                    except RadosError:
                        pass
        self.store._drop_cursors(bucket)


class _MergedCursor:
    """K-way merge over per-shard dir_list pages.

    Each shard keeps an independent cursor {buffered page, inclusive
    resume point, exhausted flag}; refills are lazy and bounded (one
    page per shard in flight), so a merged listing of max_keys costs
    at most one page fetch per shard regardless of bucket size — the
    reference's CLSRGWIssueBucketList fans out exactly the same way.

    Entries come back in global key order because every shard's pages
    are key-ordered and routing is disjoint.  `truncated` for a
    consumer that took max_keys entries is simply `peek() is not
    None` — per-shard truncation flags feed the per-shard cursors, so
    the store.py invariant (a truncated page must never be presented
    as complete) holds per shard AND merged by construction.
    """

    def __init__(self, bi: BucketIndex, oids: list[str], prefix: str,
                 marker: str, resume: str, page: int):
        self.bi = bi
        self.prefix = prefix
        self.marker = marker
        self.page = max(2, int(page))
        # per shard: [buffer list, inclusive-from, done]
        self.shards = [[None, resume, False] for _ in oids]
        self.oids = oids

    def _refill(self, i: int) -> None:
        buf, frm, done = self.shards[i]
        if done or (buf is not None and buf):
            return
        try:
            out = json.loads(self.bi._cls(
                self.oids[i], "dir_list",
                {"prefix": self.prefix, "marker": self.marker,
                 "from": frm, "max": self.page}).decode())
        except RadosError as e:
            self.bi.store._not_found(e)   # missing shard = empty
            self.shards[i] = [[], frm, True]
            return
        entries = out["entries"]
        nfrm = entries[-1][0] + "\x00" if entries else frm
        self.shards[i] = [entries, nfrm, not out["truncated"]]

    def peek(self):
        """Smallest pending (key, meta) across shards, or None."""
        best = None
        besti = -1
        for i in range(len(self.shards)):
            self._refill(i)
            buf = self.shards[i][0]
            if buf and (best is None or buf[0][0] < best[0]):
                best = buf[0]
                besti = i
        self._besti = besti
        return best

    def next(self):
        ent = self.peek()
        if ent is not None:
            self.shards[self._besti][0].pop(0)
        return ent

    def seek(self, frm: str) -> None:
        """Raise every shard's inclusive lower bound (delimiter
        rollups skip a whole folder in one hop).  Buffered entries
        below the bound drop; exhausted shards stay exhausted."""
        for st in self.shards:
            buf, cur, _done = st
            if buf:
                st[0] = [e for e in buf if e[0] >= frm]
            if frm > cur:
                st[1] = frm

"""RGW multisite-lite: async zone-to-zone bucket replication.

Re-expresses the reference's data-sync machinery
(src/rgw/rgw_data_sync.cc: per-zone change logs, a pull-based sync
agent per peer, checkpointed markers, idempotent full-object fetches)
at this build's scale:

  mod-log    every mutating store op appends {op, bucket[, key]} to
             one journal object ("rgw_modlog", cls_journal) in the
             source zone's meta pool — the rgw_datalog/bilog role
  replayer   ZoneReplayer pulls entries after its checkpoint from the
             SOURCE zone's log and RECONCILES current state into the
             destination: entries say WHAT changed, the agent fetches
             what it now IS.  Replay is therefore idempotent and
             naturally last-writer-wins, and a crashed replayer resumes
             from its cls-journal client position with at-least-once
             semantics (position advances only after apply).
  agent      ZoneSyncAgent wraps the replayer in a background thread
             (the rgw-sync-agent/radosgw sync thread role).

Scope notes (vs the reference): one-way replication per replayer (run
two for active-active; reconciliation makes crossed writes converge to
the source's current state per key), and versioned-bucket HISTORY is
not mirrored — the current object state is (the reference syncs olh +
version chains).  Multipart objects arrive materialized, so their
destination ETag is the md5 of the bytes, not the multipart ETag.
"""

from __future__ import annotations

import json
import threading
import time

import hashlib

from .store import MODLOG_OBJ, RGWError, RGWStore


class ModLogReader:
    """Cursor over a zone's mod-log (cls_journal client)."""

    def __init__(self, store: RGWStore, client_id: str):
        self.store = store
        self.client_id = client_id
        self.store.meta.execute(
            MODLOG_OBJ, "journal", "client_register",
            json.dumps({"id": client_id, "pos": -1}).encode())

    def position(self) -> int:
        raw = self.store.meta.execute(
            MODLOG_OBJ, "journal", "client_get",
            json.dumps({"id": self.client_id}).encode())
        return int(json.loads(raw.decode())["pos"])

    def entries_after(self, pos: int, max_entries: int = 256):
        raw = self.store.meta.execute(
            MODLOG_OBJ, "journal", "list",
            json.dumps({"after_seq": pos,
                        "max": max_entries}).encode())
        out = json.loads(raw.decode())
        return out["entries"], out["truncated"]

    def commit(self, pos: int) -> None:
        self.store.meta.execute(
            MODLOG_OBJ, "journal", "client_update",
            json.dumps({"id": self.client_id, "pos": pos}).encode())
        # trim consumed entries so the log stays bounded by the
        # slowest peer's backlog, not the zone's full write history
        # (the class refuses to trim past any registered client)
        try:
            self.store.meta.execute(
                MODLOG_OBJ, "journal", "trim",
                json.dumps({"to_seq": pos}).encode())
        except Exception:  # noqa: BLE001 - a slower peer holds it
            pass


class ZoneReplayer:
    """Pull changes from `src` zone's mod-log, reconcile into `dst`.

    Reference: RGWDataSyncCR + RGWBucketSyncSingleEntryCR — there the
    unit of work is also "sync this object now", not "apply this
    logged mutation"."""

    def __init__(self, src: RGWStore, dst: RGWStore,
                 zone_id: str = "peer"):
        if not src.modlog_enabled:
            raise ValueError(
                "source zone has no mod-log (RGWStore(modlog=True)); "
                "changes would be invisible to sync")
        self.src = src
        self.dst = dst
        self.reader = ModLogReader(src, zone_id)
        self.applied = 0          # observability/tests

    def full_sync(self) -> int:
        """Reconcile EVERYTHING the source currently holds — the
        catch-up pass for enabling sync on a zone with pre-mod-log
        history (reference: RGWBucketSyncCR full-sync phase before
        incremental).  Returns objects reconciled."""
        n = 0
        for bucket, _meta in self.src.list_buckets():
            self._sync_bucket(bucket)
            resume = ""
            while True:
                # the returned resume point is an INCLUSIVE token for
                # the `resume` parameter (not the exclusive marker) —
                # feeding it to marker would skip a key equal to it
                entries, _cps, truncated, resume = \
                    self.src.list_objects(bucket, "", "", 1000,
                                          "", resume)
                for key, _m in entries:
                    self._sync_object(bucket, key)
                    n += 1
                if not truncated or not resume:
                    break
        return n

    def sync_once(self, batch: int = 256) -> int:
        """One pull-apply-commit round; returns entries consumed.
        Loops until the log is drained."""
        total = 0
        while True:
            pos = self.reader.position()
            entries, truncated = self.reader.entries_after(pos, batch)
            if not entries:
                return total
            # coalesce: N changes to one key in this batch need one
            # reconciliation (the reference's sync-status markers get
            # the same effect by syncing objects, not log records)
            seen: set[tuple] = set()
            todo = []
            for seq, e in reversed(entries):
                ident = (e["op"], e["bucket"], e.get("key"))
                if ident in seen:
                    continue
                seen.add(ident)
                todo.append((seq, e))
            for _seq, e in reversed(todo):
                self._apply(e)
                self.applied += 1
            self.reader.commit(entries[-1][0])
            total += len(entries)
            if not truncated:
                return total

    # -- reconciliation -----------------------------------------------------

    def _apply(self, e: dict) -> None:
        if e["op"] == "sync_bucket":
            self._sync_bucket(e["bucket"])
        elif e["op"] == "sync":
            self._sync_object(e["bucket"], e["key"])

    def _sync_bucket(self, bucket: str) -> None:
        smeta = self.src._bucket_meta(bucket)
        if smeta is None:
            # source bucket gone: its objects' deletes were logged
            # first (S3 requires empty buckets), so this should succeed
            try:
                self.dst.delete_bucket(bucket)
            except RGWError:
                pass              # not there / refilled by later ops
            return
        if self.dst._bucket_meta(bucket) is None:
            self.dst.create_bucket(bucket, owner=smeta.get("owner"),
                                   acl=smeta.get("acl", "private"))
        # mirror the whole meta row (acl/versioning/policy/lifecycle)
        # wholesale — field-by-field would drift as the dialect grows
        from .store import BUCKETS_OBJ
        self.dst._cls(self.dst.meta, BUCKETS_OBJ, "dir_add", {
            "key": bucket, "meta": {k: v for k, v in smeta.items()}})

    def _sync_object(self, bucket: str, key: str) -> None:
        if self.dst._bucket_meta(bucket) is None:
            self._sync_bucket(bucket)
            if self.dst._bucket_meta(bucket) is None:
                return            # bucket gone on both sides
        try:
            body, meta = self.src.get_object(bucket, key)
        except RGWError:
            try:
                self.dst.delete_object(bucket, key)
            except RGWError:
                pass              # already absent
            return
        # idempotency guard: skip the put when dst already matches —
        # on a versioning-Enabled bucket a blind re-put would mint a
        # spurious version per at-least-once retry.  Compared by
        # md5-of-bytes (not source etag: a multipart source's etag is
        # the multipart form while dst materializes one object).
        body = bytes(body)
        want_etag = hashlib.md5(body).hexdigest()
        extra = {k: meta[k] for k in ("owner", "acl") if k in meta}
        try:
            dmeta = self.dst.head_object(bucket, key)
        except RGWError:
            dmeta = None
        if dmeta is not None and dmeta.get("etag") == want_etag and \
                all(dmeta.get(k) == v for k, v in extra.items()):
            return
        self.dst.put_object(bucket, key, body, extra=extra)


class ZoneSyncAgent:
    """Background replayer thread (the radosgw sync-thread role)."""

    def __init__(self, src: RGWStore, dst: RGWStore,
                 zone_id: str = "peer", interval: float = 1.0):
        self.replayer = ZoneReplayer(src, dst, zone_id)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"rgw-sync-{zone_id}")

    def start(self) -> "ZoneSyncAgent":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.replayer.sync_once()
            except Exception:  # noqa: BLE001 - peer down: retry next
                continue           # tick from the same checkpoint

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(10)

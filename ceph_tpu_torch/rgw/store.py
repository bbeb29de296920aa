"""RGWRados role: bucket/object layout over librados.

Re-expresses the reference's src/rgw/rgw_rados.cc storage model at the
fidelity the S3 surface needs:

- bucket registry: a directory object ("buckets") in the meta pool,
  maintained by the rgw object class (atomic server-side updates —
  reference cls_rgw + the RGWRados bucket metadata handlers)
- per-bucket index: hash-sharded directory objects in the meta pool
  (reference bucket index shards, cls_rgw).  Routing, layout and the
  merge-sorted listing cursor live in rgw/bucket_index.py; online
  dynamic resharding in rgw/reshard.py.  Buckets created without a
  shard count keep the legacy single object ("index.<bucket>").
- object data: one rados object per S3 object in the data pool, named
  with a length-prefixed bucket separator so keys may contain any
  character (reference rgw_obj raw-object naming)
- multipart uploads (reference rgw_op.h:1716-1754 RGWInitMultipart /
  RGWListMultipart / RGWCompleteMultipart / RGWAbortMultipart and the
  RGWUploadPartInfo manifest model): each part is its own RADOS object
  in the data pool; the completed S3 object's index entry carries a
  parts manifest instead of data, and GET stitches the parts —
  completing a 5 TB upload moves no data, exactly like the reference's
  manifest-based RGWObjManifest.

The data pool may be erasure-coded (pass an EC profile); the meta pool
is replicated, matching the reference's constraint that index pools be
replicated.
"""

from __future__ import annotations

import errno
import hashlib
import json
import time

from ..common.options import SCHEMA
from ..rados.client import RadosError
from .bucket_index import BucketIndex
from .reshard import Resharder

META_POOL = ".rgw.meta"
DATA_POOL = ".rgw.data"
BUCKETS_OBJ = "buckets"
MODLOG_OBJ = "rgw_modlog"


class RGWError(Exception):
    def __init__(self, status: int, code: str, msg: str = ""):
        super().__init__(f"{code}: {msg}")
        self.status = status
        self.code = code


def _data_oid(bucket: str, key: str) -> str:
    return f"{len(bucket)}_{bucket}_{key}"


def _part_oid(bucket: str, upload_id: str, part_num: int) -> str:
    # distinct namespace from _data_oid (which always starts with a
    # digit): a user key can never collide with a part object
    # (reference uses the __multipart_ shadow-object namespace)
    return f"mp_{len(bucket)}_{bucket}_{upload_id}.{part_num}"


def _version_oid(bucket: str, version_id: str, key: str) -> str:
    # archived version payloads (non-colliding namespace, see above)
    return f"vr_{len(bucket)}_{bucket}_{version_id}_{key}"


class RGWStore:
    def __init__(self, client, ec_profile: str | None = None,
                 pg_num: int = 8, modlog: bool = False,
                 usage_log: bool = False):
        self.client = client
        self._ensure_pools(ec_profile, pg_num)
        self.meta = client.open_ioctx(META_POOL)
        self.data = client.open_ioctx(DATA_POOL)
        self._cls(self.meta, BUCKETS_OBJ, "dir_init")
        # zone mod-log: one journal object recording WHAT changed
        # (reference rgw_datalog/bilog, the feed of rgw_data_sync.cc);
        # the sync agent (rgw/sync.py) reconciles current state per
        # entry, so replay is idempotent.  OPT-IN (multisite zones
        # only): a standalone zone must not pay a journal append per
        # mutation; enabling sync on an existing zone starts with
        # ZoneReplayer.full_sync() to cover the pre-log history.
        self.modlog_enabled = modlog
        if modlog:
            self.meta.execute(MODLOG_OBJ, "journal", "create", b"")
        # usage/ops log (reference rgw_enable_usage_log, default off):
        # one cls_log append per mutation when enabled
        self.usage_log_enabled = usage_log
        # bucket notifications (rgw/notify.py), opt-in
        self.notify = None
        # bucket-meta rows are read-modify-written whole (versioning/
        # acl/lifecycle share one row); concurrent HTTP handler threads
        # must not interleave their RMWs or the second write silently
        # drops the first's field
        import threading as _threading
        self._bmeta_lock = _threading.Lock()
        # every index/versions plane access routes through the shard
        # layer (shard selection, dual-write during reshard, merged
        # listing); quota admission is a cls_user reservation — no
        # process-local pending pot survives here (see _quota_gate)
        self.index = BucketIndex(self)
        self.resharder = Resharder(self)
        # continuation-cursor cache: a paginated listing re-entered
        # via its resume token continues the live merged cursor
        # (buffered shard pages intact) instead of re-seeking every
        # shard — without it each page pays one dir_list per shard,
        # so page latency grows with shard count.  Keyed by the full
        # request shape + token; invalidated on any index mutation
        # through this store and on layout (reshard) change, so a
        # reused cursor can never show state older than this
        # gateway's own acked writes.
        from collections import OrderedDict as _OD
        self._cursor_cache: dict = _OD()
        self._cursor_mu = _threading.Lock()

    def _ensure_pools(self, ec_profile, pg_num) -> None:
        for name, kind in ((META_POOL, "replicated"),
                           (DATA_POOL,
                            "erasure" if ec_profile else "replicated")):
            try:
                kw = {"pg_num": pg_num}
                if kind == "erasure":
                    kw["erasure_code_profile"] = ec_profile
                else:
                    kw["size"] = 2
                self.client.create_pool(name, kind, **kw)
            except RadosError as e:
                if e.errno != errno.EEXIST:
                    raise

    def _stash_cursor(self, key: tuple, lay, mcur) -> None:
        with self._cursor_mu:
            self._cursor_cache[key] = ((lay.shards, lay.gen), mcur)
            self._cursor_cache.move_to_end(key)
            while len(self._cursor_cache) > 32:
                self._cursor_cache.popitem(last=False)

    def _take_cursor(self, key: tuple, lay):
        """Pop a stashed cursor if its layout still matches (a reshard
        cutover between pages orphans old-gen cursors)."""
        with self._cursor_mu:
            ent = self._cursor_cache.pop(key, None)
        if ent is not None and ent[0] == (lay.shards, lay.gen):
            return ent[1]
        return None

    def _drop_cursors(self, bucket: str) -> None:
        with self._cursor_mu:
            for k in [k for k in self._cursor_cache if k[0] == bucket]:
                del self._cursor_cache[k]

    def _cls(self, io, oid: str, method: str, payload: dict | None = None
             ) -> bytes:
        inp = json.dumps(payload).encode() if payload is not None else b""
        return io.execute(oid, "rgw", method, inp)

    def _modlog(self, op: str, bucket: str,
                key: str | None = None) -> None:
        """Mutations log TWICE: once after validation/before mutating
        (write-ahead: a crash between log and mutation reconciles to a
        no-op, while mutate-then-crash-before-log would diverge the
        zones forever) and once after success (a replayer that consumed
        the write-ahead entry BEFORE the mutation landed would
        otherwise commit past it and never see the final state).
        Failed ops log nothing.  The replayer coalesces duplicates."""
        if not self.modlog_enabled:
            return
        entry = {"op": op, "bucket": bucket, "ts": time.time()}
        if key is not None:
            entry["key"] = key
        self.meta.execute(MODLOG_OBJ, "journal", "append",
                          json.dumps({"entry": entry}).encode())

    # -- user accounting + quotas (cls_user; reference rgw_quota.cc +
    #    cls_user bucket stats) + usage log (cls_log; rgw_usage.cc) ---------

    @staticmethod
    def _user_oid(user: str) -> str:
        return f"user.{user}"

    def _user_stats(self, user: str | None, bucket: str,
                    d_objects: int, d_bytes: int) -> None:
        """Server-side stats delta on the owner's account object.
        Accounting tracks the CURRENT index view (archived version
        rows and version surgery are not separately charged — noted
        deviation from the reference's full-olh accounting)."""
        if not user or (d_objects == 0 and d_bytes == 0):
            return
        self.meta.execute(self._user_oid(user), "user", "add_stats",
                          json.dumps({"bucket": bucket,
                                      "objects": d_objects,
                                      "bytes": d_bytes}).encode())

    def _account_overwrite(self, bucket: str, key: str | None,
                           cur: dict | None, cur_owner: str | None,
                           new_owner: str | None,
                           new_bytes: int) -> None:
        """Post-success accounting for a write that displaced `cur`:
        release the OLD owner's charge and charge the NEW owner — a
        cross-owner overwrite must not leave the previous owner paying
        for bytes that no longer exist (and the clamp in cls_user must
        never eat the new owner's charge)."""
        if cur is not None and cur_owner == new_owner:
            self._user_stats(new_owner, bucket, 0,
                             new_bytes - cur.get("size", 0))
        else:
            if cur is not None:
                self._user_stats(cur_owner, bucket, -1,
                                 -cur.get("size", 0))
            self._user_stats(new_owner, bucket, 1, new_bytes)
        self._usage(new_owner, "put_obj", bucket, key, new_bytes)

    def get_user_header(self, user: str) -> dict:
        raw = self.meta.execute(self._user_oid(user), "user",
                                "get_header", b"")
        return json.loads(raw.decode())

    def set_user_quota(self, user: str, max_objects: int = -1,
                       max_bytes: int = -1) -> None:
        self.meta.execute(self._user_oid(user), "user", "set_quota",
                          json.dumps({"max_objects": max_objects,
                                      "max_bytes": max_bytes}).encode())

    def _quota_gate(self, user: str | None, add_objects: int,
                    add_bytes: int) -> str | None:
        """Admit-or-403 a write against the owner's quota AND reserve
        its growth (reference RGWQuotaHandler::check_quota before
        every put).  Check and reservation are ONE atomic cls_user
        call on the user object — the OSD serializes class calls per
        object, so racing writers from ANY process or host see each
        other's live reservations and cannot jointly overshoot
        max_bytes/max_objects (this closes the process-local pending
        pot's documented cross-process window).  Returns a reservation
        token; every successful gate must be paired with a
        `_quota_release(user, token)` once the op's accounting has
        landed (or the op failed).  A writer that dies in between
        stops counting against the quota after
        rgw_quota_reservation_ttl_s.

        Residual boundary effect: between `_user_stats` landing and
        the release, growth is briefly counted twice (reservation +
        totals), which can only falsely DENY at the boundary, never
        falsely admit."""
        if not user:
            return None
        try:
            raw = self.meta.execute(
                self._user_oid(user), "user", "reserve",
                json.dumps({
                    "objects": add_objects, "bytes": add_bytes,
                    "ttl": SCHEMA["rgw_quota_reservation_ttl_s"
                                  ].default}).encode())
        except RadosError as e:
            if e.errno == errno.EDQUOT:
                raise RGWError(403, "QuotaExceeded",
                               f"user {user}: {e}") from e
            raise
        return json.loads(raw.decode())["token"]

    def _quota_release(self, user: str | None,
                       token: str | None) -> None:
        """Return a gate's reservation (accounting landed or op died)."""
        if not user or not token:
            return
        self.meta.execute(self._user_oid(user), "user", "release",
                          json.dumps({"token": token}).encode())

    def _usage(self, user: str | None, op: str, bucket: str,
               key: str | None, nbytes: int) -> None:
        if not self.usage_log_enabled:
            return
        entry = {"user": user or "anonymous", "op": op,
                 "bucket": bucket, "bytes": nbytes}
        if key is not None:
            entry["key"] = key
        self.meta.execute("rgw_usagelog", "log", "add", json.dumps(
            {"ts": time.time(), "entry": entry}).encode())

    def get_usage(self, from_ts: float = 0.0, to_ts: float = 1e18,
                  marker: str = "", max_entries: int = 256) -> dict:
        raw = self.meta.execute("rgw_usagelog", "log", "list",
                                json.dumps({"from_ts": from_ts,
                                            "to_ts": to_ts,
                                            "marker": marker,
                                            "max": max_entries}
                                           ).encode())
        return json.loads(raw.decode())

    def trim_usage(self, to_ts: float) -> None:
        self.meta.execute("rgw_usagelog", "log", "trim",
                          json.dumps({"to_ts": to_ts}).encode())

    def enable_notifications(self, push_interval: float = 0.25):
        """Attach the notification manager (reference rgw_notify);
        returns it for topic/binding admin."""
        from .notify import NotificationManager
        if self.notify is None:
            self.notify = NotificationManager(self, push_interval)
        return self.notify

    def _publish(self, bucket: str, key: str, event: str,
                 size: int = 0, bmeta: dict | None = None) -> None:
        if self.notify is not None:
            self.notify.publish(bucket, key, event, size, bmeta=bmeta)

    # -- buckets -------------------------------------------------------------

    def create_bucket(self, bucket: str, owner: str | None = None,
                      acl: str = "private",
                      shards: int | None = None) -> None:
        """`shards` picks the index shard count (None = the
        rgw_bucket_index_shards default).  shards == 1 keeps the
        legacy single-object layout; > 1 creates a hash-sharded index
        at generation 1 (generation 0 is the legacy spelling)."""
        if not bucket or "/" in bucket:
            raise RGWError(400, "InvalidBucketName", bucket)
        if shards is None:
            shards = SCHEMA["rgw_bucket_index_shards"].default
        shards = int(shards)
        if shards < 1:
            raise RGWError(400, "InvalidArgument",
                           f"shard count {shards}")
        meta: dict = {"created": time.time()}
        if owner is not None:
            meta["owner"] = owner
        if acl != "private":
            meta["acl"] = acl
        if shards > 1:
            meta["index"] = {"shards": shards, "gen": 1}
        self._modlog("sync_bucket", bucket)
        self._cls(self.meta, BUCKETS_OBJ, "dir_add", {
            "key": bucket, "meta": meta})
        self.index.init(bucket, shards, 1 if shards > 1 else 0)
        self._modlog("sync_bucket", bucket)     # post-success

    def set_bucket_acl(self, bucket: str, acl: str) -> None:
        with self._bmeta_lock:
            meta = self._bucket_meta(bucket)
            if meta is None:
                raise RGWError(404, "NoSuchBucket", bucket)
            meta["acl"] = acl               # RMW: keep created/owner etc.
            self._modlog("sync_bucket", bucket)
            self._cls(self.meta, BUCKETS_OBJ, "dir_add", {
                "key": bucket, "meta": meta})
            self._modlog("sync_bucket", bucket)  # post-success

    def set_bucket_policy(self, bucket: str, policy: dict | None) -> None:
        """Attach (or with None, detach) a validated policy document to
        the bucket meta (reference: RGW_ATTR_IAM_POLICY xattr on the
        bucket instance, src/rgw/rgw_iam_policy.cc consumers)."""
        with self._bmeta_lock:
            meta = self._bucket_meta(bucket)
            if meta is None:
                raise RGWError(404, "NoSuchBucket", bucket)
            if policy is None:
                meta.pop("policy", None)
            else:
                meta["policy"] = policy
            self._modlog("sync_bucket", bucket)
            self._cls(self.meta, BUCKETS_OBJ, "dir_add", {
                "key": bucket, "meta": meta})
            self._modlog("sync_bucket", bucket)  # post-success

    def get_bucket_policy(self, bucket: str) -> dict | None:
        meta = self._bucket_meta(bucket)
        if meta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        return meta.get("policy")

    def set_object_acl(self, bucket: str, key: str, acl: str) -> None:
        cur = self._current_meta(bucket, key)
        if cur is None:
            raise RGWError(404, "NoSuchKey", key)
        cur["acl"] = acl
        self._modlog("sync", bucket, key)
        self.index.add(bucket, "index", key, cur)
        self._modlog("sync", bucket, key)       # post-success

    # -- lifecycle (reference rgw_lc.h: per-bucket rules evaluated by
    #    a background worker) ----------------------------------------------

    def set_lifecycle(self, bucket: str, rules: list[dict]) -> None:
        """rules: [{id, prefix, days?, expired_obj_delete_marker?,
        abort_mpu_days?}, ...] — the Expiration(Days) /
        ExpiredObjectDeleteMarker / AbortIncompleteMultipartUpload
        subset of the reference's LC rule grammar."""
        with self._bmeta_lock:
            meta = self._bucket_meta(bucket)
            if meta is None:
                raise RGWError(404, "NoSuchBucket", bucket)
            for r in rules:
                if not (r.get("days") or r.get("abort_mpu_days") or
                        r.get("expired_obj_delete_marker")):
                    raise RGWError(400, "MalformedXML",
                                   f"rule {r.get('id', '?')} has no action")
            meta["lifecycle"] = rules
            self._modlog("sync_bucket", bucket)
            self._cls(self.meta, BUCKETS_OBJ, "dir_add", {
                "key": bucket, "meta": meta})
            self._modlog("sync_bucket", bucket)  # post-success

    def get_lifecycle(self, bucket: str) -> list[dict]:
        meta = self._bucket_meta(bucket)
        if meta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        return meta.get("lifecycle", [])

    def delete_lifecycle(self, bucket: str) -> None:
        with self._bmeta_lock:
            meta = self._bucket_meta(bucket)
            if meta is None:
                raise RGWError(404, "NoSuchBucket", bucket)
            meta.pop("lifecycle", None)
            self._modlog("sync_bucket", bucket)
            self._cls(self.meta, BUCKETS_OBJ, "dir_add", {
                "key": bucket, "meta": meta})
            self._modlog("sync_bucket", bucket)  # post-success

    def lifecycle_sweep(self, now: float | None = None) -> dict:
        """One pass over every bucket with lifecycle rules (the
        reference's RGWLC::process).  Returns counters for
        observability/tests.  `now` is injectable for time-mocked
        tests."""
        now = time.time() if now is None else now
        stats = {"expired": 0, "markers_removed": 0, "mpu_aborted": 0}
        for bucket, bmeta in self.list_buckets():
            rules = bmeta.get("lifecycle")
            if not rules:
                continue
            for rule in rules:
                prefix = rule.get("prefix", "")
                days = rule.get("days")
                if days:
                    cutoff = now - days * 86400
                    marker = ""
                    while True:
                        entries, _cps, trunc, nm = self.list_objects(
                            bucket, prefix=prefix, marker=marker,
                            max_keys=1000)
                        for k, m in entries:
                            if m.get("mtime", now) <= cutoff:
                                try:
                                    self.delete_object(bucket, k)
                                    stats["expired"] += 1
                                except RGWError:
                                    pass
                        if not trunc or not entries:
                            break
                        marker = entries[-1][0]
                if rule.get("expired_obj_delete_marker"):
                    # a delete marker whose key has NO other versions
                    # is dead weight: remove it (S3
                    # ExpiredObjectDeleteMarker)
                    by_key: dict[str, list] = {}
                    for row in self.list_versions(
                            bucket, prefix=prefix, max_keys=100000):
                        by_key.setdefault(row["key"], []).append(row)
                    for k, rows in by_key.items():
                        if len(rows) == 1 and \
                                rows[0].get("delete_marker"):
                            try:
                                self.delete_object_version(
                                    bucket, k, rows[0]["version_id"])
                                stats["markers_removed"] += 1
                            except RGWError:
                                pass
                mpu_days = rule.get("abort_mpu_days")
                if mpu_days:
                    cutoff = now - mpu_days * 86400
                    for k, upload_id, m in \
                            self.list_multipart_uploads(bucket):
                        if not k.startswith(prefix):
                            continue
                        if m.get("initiated", now) <= cutoff:
                            try:
                                self.abort_multipart(bucket, k,
                                                     upload_id)
                                stats["mpu_aborted"] += 1
                            except RGWError:
                                pass
        return stats

    @staticmethod
    def _not_found(e: RadosError) -> bool:
        """Only ENOENT means absence; anything else is a cluster fault
        that must surface as a 5xx, not a phantom 404 (a sync client
        treating EIO as 'gone' would re-upload or diverge)."""
        if e.errno == errno.ENOENT:
            return True
        raise RGWError(503, "ServiceUnavailable", str(e))

    def bucket_exists(self, bucket: str) -> bool:
        try:
            self._cls(self.meta, BUCKETS_OBJ, "dir_get", {"key": bucket})
            return True
        except RadosError as e:
            return not self._not_found(e)

    def delete_bucket(self, bucket: str) -> None:
        self._require_bucket(bucket)
        count = self.index.count(bucket)
        if count:
            raise RGWError(409, "BucketNotEmpty", bucket)
        # in-flight multipart uploads also block deletion (S3
        # semantics); otherwise their parts leak in the data pool and
        # the upload record resurrects on bucket recreation
        if self.list_multipart_uploads(bucket):
            raise RGWError(409, "BucketNotEmpty",
                           f"{bucket}: multipart uploads in progress")
        # surviving versions (incl. delete markers) hold data: block
        for row in self.list_versions(bucket, max_keys=1):
            raise RGWError(409, "BucketNotEmpty",
                           f"{bucket}: object versions remain")
        self._modlog("sync_bucket", bucket)
        bmeta = self._bucket_meta(bucket) or {}
        owner = bmeta.get("owner")
        if owner:
            self.meta.execute(self._user_oid(owner), "user",
                              "rm_bucket",
                              json.dumps({"bucket": bucket}).encode())
        self._cls(self.meta, BUCKETS_OBJ, "dir_rm", {"key": bucket})
        self.index.remove_all(bucket, bmeta=bmeta)
        try:
            self.meta.remove(f"uploads.{bucket}")
        except RadosError:
            pass
        self._modlog("sync_bucket", bucket)     # post-success

    def list_buckets(self) -> list[tuple[str, dict]]:
        out = json.loads(self._cls(self.meta, BUCKETS_OBJ, "dir_list",
                                   {"max": 10000}).decode())
        return [(k, m) for k, m in out["entries"]]

    def _require_bucket(self, bucket: str) -> None:
        if not self.bucket_exists(bucket):
            raise RGWError(404, "NoSuchBucket", bucket)

    # -- objects -------------------------------------------------------------

    # -- versioning (reference rgw bucket versioning + RGWListBucketV
    #    / delete markers) --------------------------------------------------

    def _bucket_meta(self, bucket: str) -> dict | None:
        """One round-trip for existence + metadata (the object hot
        path must not probe the bucket directory three times)."""
        try:
            raw = self._cls(self.meta, BUCKETS_OBJ, "dir_get",
                            {"key": bucket})
        except RadosError as e:
            self._not_found(e)
            return None
        return json.loads(raw.decode())

    def set_versioning(self, bucket: str, status: str) -> None:
        if status not in ("Enabled", "Suspended"):
            raise RGWError(400, "IllegalVersioningConfiguration",
                           status)
        with self._bmeta_lock:
            meta = self._bucket_meta(bucket)
            if meta is None:
                raise RGWError(404, "NoSuchBucket", bucket)
            meta["versioning"] = status       # RMW: keep created etc.
            self._modlog("sync_bucket", bucket)
            self._cls(self.meta, BUCKETS_OBJ, "dir_add", {
                "key": bucket, "meta": meta})
            self._modlog("sync_bucket", bucket)  # post-success

    def get_versioning(self, bucket: str) -> str:
        meta = self._bucket_meta(bucket)
        if meta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        return meta.get("versioning", "")

    @staticmethod
    def _new_version_id() -> str:
        # time-prefixed so lexical DESC order of the version dir rows
        # is newest-first (reference uses instance ids w/ an index
        # sort key); inverted timestamp keeps newest first
        import os
        inv = (1 << 63) - time.time_ns()
        return f"{inv:016x}.{os.urandom(6).hex()}"

    def _archive_version(self, bucket: str, key: str, meta: dict,
                         version_id: str,
                         bmeta: dict | None = None) -> None:
        """Record one immutable version row (newest sorts first).
        Version rows shard by PARENT key (all versions of a key
        colocate), so per-key order survives sharding."""
        self.index.add(bucket, "versions", f"{key}\x00{version_id}",
                       {**meta, "version_id": version_id},
                       route=key, bmeta=bmeta)

    def list_versions(self, bucket: str, prefix: str = "",
                      max_keys: int = 1000) -> list[dict]:
        """Version rows up to max_keys, newest-first per key; the
        newest row of each key is marked latest.  The merged cursor
        PAGINATES every underlying shard — a truncated page silently
        presented as complete would let version deletion drop live
        index entries — and yields rows in global row-key order
        (= key asc, newest version first within a key, because the
        inverted-timestamp version ids sort newest-first and a key's
        rows all live in one shard)."""
        self._require_bucket(bucket)
        cur = self.index.cursor(bucket, "versions", prefix=prefix,
                                page=min(max_keys, 1000) + 1)
        rows: list[dict] = []
        latest_seen: set[str] = set()
        while len(rows) < max_keys:
            ent = cur.next()
            if ent is None:
                break
            k, m = ent
            key = k.split("\x00", 1)[0]
            rows.append({"key": key, **m,
                         "is_latest": key not in latest_seen})
            latest_seen.add(key)
        return rows

    def _versions_of_key(self, bucket: str, key: str) -> list[dict]:
        # exact-key prefix: 'key' alone would also match 'keysuffix'
        return self.list_versions(bucket, prefix=f"{key}\x00",
                                  max_keys=100000)

    def _current_meta(self, bucket: str, key: str,
                      bmeta: dict | None = None) -> dict | None:
        try:
            raw = self.index.get(bucket, "index", key, bmeta=bmeta)
        except RadosError as e:
            self._not_found(e)
            return None
        return json.loads(raw.decode())

    def _archive_null_version(self, bucket: str, key: str,
                              bmeta: dict | None = None) -> None:
        """An object written BEFORE versioning was enabled has no
        version row; S3 makes it the "null" version.  Archive its
        existing meta (data stays at _data_oid / its multipart parts —
        the row records where) so enabling versioning never orphans or
        destroys pre-existing data."""
        cur = self._current_meta(bucket, key, bmeta=bmeta)
        if cur is None or cur.get("version_id"):
            return              # absent, or already versioned
        self._archive_version(bucket, key,
                              {**cur, "null_data": True}, "null",
                              bmeta=bmeta)

    def put_object(self, bucket: str, key: str, body: bytes,
                   extra: dict | None = None) -> str:
        """Returns the ETag (md5 hex, S3 semantics).  On a versioned
        bucket every PUT archives a new immutable version; the current
        pointer rides the bucket index like before.  `extra` merges
        additional rows into the object meta (owner/acl stamps from
        the gateway's auth layer)."""
        bmeta = self._bucket_meta(bucket)
        if bmeta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        owner = (extra or {}).get("owner") or bmeta.get("owner")
        cur = self._current_meta(bucket, key, bmeta=bmeta)
        cur_owner = (cur or {}).get("owner") or bmeta.get("owner")
        same = (cur is None or cur_owner == owner)
        # quota admits the NEW owner's growth; a same-owner overwrite
        # only pays the size delta
        q_obj = (0 if cur else 1) if same else 1
        q_bytes = (len(body) - (cur or {}).get("size", 0)) \
            if same else len(body)
        token = self._quota_gate(owner, q_obj, q_bytes)
        try:
            etag = hashlib.md5(body).hexdigest()
            self._modlog("sync", bucket, key)
            if bmeta.get("versioning") == "Enabled":
                self._archive_null_version(bucket, key)
                vid = self._new_version_id()
                meta = {"size": len(body), "etag": etag,
                        "mtime": time.time(), **(extra or {})}
                self.data.write_full(_version_oid(bucket, vid, key),
                                     body)
                self._archive_version(bucket, key, meta, vid,
                                      bmeta=bmeta)
                self.index.add(bucket, "index", key,
                               {**meta, "version_id": vid},
                               bmeta=bmeta)
                self._account_overwrite(bucket, key, cur, cur_owner,
                                        owner, len(body))
                self._publish(bucket, key, "s3:ObjectCreated:Put",
                              len(body), bmeta=bmeta)
                self._modlog("sync", bucket, key)   # post-success
                return etag
            suspended = bool(bmeta.get("versioning"))  # "" = never
            reap = self._displaced_manifests(bucket, key, suspended,
                                             cur=cur)
            meta = {"size": len(body), "etag": etag,
                    "mtime": time.time(), **(extra or {})}
            self.data.write_full(_data_oid(bucket, key), body)
            self.index.add(bucket, "index", key, meta, bmeta=bmeta)
            if suspended:
                # Suspended bucket: S3 says the PUT replaces the null
                # version — (re)write the null row to match the bytes
                self._archive_version(bucket, key,
                                      {**meta, "null_data": True},
                                      "null", bmeta=bmeta)
            for m in reap:
                self._reap_manifest(bucket, m)
            self._account_overwrite(bucket, key, cur, cur_owner, owner,
                                    len(body))
            self._publish(bucket, key, "s3:ObjectCreated:Put",
                          len(body), bmeta=bmeta)
            self._modlog("sync", bucket, key)       # post-success
            return etag
        finally:
            # accounting has landed (or the op died): the reservation
            # hands back to the shared totals
            self._quota_release(owner, token)

    def get_object_version(self, bucket: str, key: str,
                           version_id: str) -> tuple[bytes, dict]:
        self._require_bucket(bucket)
        try:
            raw = self.index.get(bucket, "versions",
                                 f"{key}\x00{version_id}", route=key)
        except RadosError as e:
            self._not_found(e)
            raise RGWError(404, "NoSuchVersion", version_id) from e
        meta = json.loads(raw.decode())
        if meta.get("delete_marker"):
            raise RGWError(405, "MethodNotAllowed",
                           "this version is a delete marker")
        manifest = meta.get("multipart")
        if manifest:
            # multipart versions (null or minted) read their parts in
            # place — each complete has a unique upload_id, so part
            # objects never collide across versions
            body = b"".join(
                bytes(self.data.read(_part_oid(
                    bucket, manifest["upload_id"], num), size))
                for num, size in manifest["parts"])
            return body, meta
        if meta.get("null_data"):
            body = self.data.read(_data_oid(bucket, key), meta["size"])
        else:
            body = self.data.read(
                _version_oid(bucket, version_id, key), meta["size"])
        return bytes(body), meta

    def delete_object_version(self, bucket: str, key: str,
                              version_id: str) -> None:
        """Permanent removal of ONE version (S3 semantics: the only
        way to truly destroy data on a versioned bucket).  Removing
        the current version promotes the next-newest."""
        self._require_bucket(bucket)
        vmeta = self._version_row(bucket, key, version_id)
        if vmeta is None:
            raise RGWError(404, "NoSuchVersion", version_id)
        bmeta = self._bucket_meta(bucket) or {}
        pre_cur = self._current_meta(bucket, key, bmeta=bmeta)
        self._modlog("sync", bucket, key)
        try:
            self.index.rm(bucket, "versions",
                          f"{key}\x00{version_id}", route=key,
                          bmeta=bmeta)
        except RadosError as e:
            self._not_found(e)
            raise RGWError(404, "NoSuchVersion", version_id) from e
        if vmeta.get("multipart"):
            # a multipart version owns its parts (unique upload_id)
            self._reap_manifest(bucket, vmeta["multipart"])
        elif version_id == "null":
            # the null version's payload lives at the unversioned
            # location; reap it
            try:
                self.data.remove(_data_oid(bucket, key))
            except RadosError:
                pass
        else:
            try:
                self.data.remove(_version_oid(bucket, version_id, key))
            except RadosError:
                pass
        cur = self._current_meta(bucket, key, bmeta=bmeta)
        cur_vid = cur.get("version_id") if cur is not None else None
        null_is_current = (cur is not None and cur_vid is None and
                           version_id == "null")
        if (cur is not None and cur_vid == version_id) or \
                null_is_current:
            # promote the next-newest remaining REAL version; a delete
            # marker on top means the key stays absent, never becomes
            # a phantom zero-byte object
            remaining = self._versions_of_key(bucket, key)
            nxt = remaining[0] if remaining else None
            if nxt is not None and not nxt.get("delete_marker"):
                drop = {"key", "is_latest"}
                if nxt.get("null_data"):
                    # restoring the null version restores the plain
                    # unversioned entry (data at _data_oid / manifest)
                    drop |= {"version_id", "null_data"}
                self.index.add(bucket, "index", key,
                               {k: v for k, v in nxt.items()
                                if k not in drop}, bmeta=bmeta)
            else:
                try:
                    self.index.rm(bucket, "index", key, bmeta=bmeta)
                except RadosError as e:
                    self._not_found(e)
        # CURRENT-view accounting: deleting the current version (or
        # promoting a different-size predecessor) changes the index
        # view the user stats track — without this, version surgery
        # permanently leaks quota
        post_cur = self._current_meta(bucket, key, bmeta=bmeta)
        if (pre_cur is None) != (post_cur is None) or (
                pre_cur is not None and post_cur is not None and
                (pre_cur.get("size"), pre_cur.get("owner")) !=
                (post_cur.get("size"), post_cur.get("owner"))):
            default_owner = bmeta.get("owner")
            if pre_cur is not None:
                self._user_stats(
                    pre_cur.get("owner") or default_owner, bucket,
                    -1, -pre_cur.get("size", 0))
            if post_cur is not None:
                self._user_stats(
                    post_cur.get("owner") or default_owner, bucket,
                    1, post_cur.get("size", 0))
        self._publish(bucket, key, "s3:ObjectRemoved:Delete",
                      bmeta=bmeta)
        self._modlog("sync", bucket, key)       # post-success

    def _version_row(self, bucket: str, key: str,
                     version_id: str) -> dict | None:
        try:
            raw = self.index.get(bucket, "versions",
                                 f"{key}\x00{version_id}", route=key)
        except RadosError as e:
            self._not_found(e)
            return None
        return json.loads(raw.decode())

    def _displaced_manifests(self, bucket: str, key: str,
                             suspended: bool,
                             cur: dict | None = None) -> list[dict]:
        """Manifests whose LAST reference disappears when a
        non-versioned write/delete displaces the current object: the
        current index row's manifest (unless its own version row
        still references it), plus — on a Suspended bucket, where S3
        says the write REPLACES the null version — the existing null
        row's manifest.  Reaping anything else would destroy an
        archived version's data; reaping less leaks parts forever."""
        out: dict[str, dict] = {}
        if cur is None:
            cur = self._current_meta(bucket, key)
        if cur and cur.get("multipart") and not cur.get("version_id"):
            out[cur["multipart"]["upload_id"]] = cur["multipart"]
        if suspended:
            row = self._version_row(bucket, key, "null")
            if row and row.get("multipart"):
                out[row["multipart"]["upload_id"]] = row["multipart"]
        return list(out.values())

    def _reap_manifest(self, bucket: str, manifest: dict | None) -> None:
        """Remove the part objects an overwritten/deleted manifest
        referenced (reference RGWRados gc of multipart parts)."""
        if not manifest:
            return
        for num, _size in manifest["parts"]:
            try:
                self.data.remove(
                    _part_oid(bucket, manifest["upload_id"], num))
            except RadosError:
                pass

    def head_object(self, bucket: str, key: str) -> dict:
        self._require_bucket(bucket)
        try:
            raw = self.index.get(bucket, "index", key)
        except RadosError as e:
            self._not_found(e)
            raise RGWError(404, "NoSuchKey", key) from e
        return json.loads(raw.decode())

    def get_object(self, bucket: str, key: str,
                   meta: dict | None = None) -> tuple[bytes, dict]:
        """`meta` short-circuits the index lookup when the caller
        already fetched the row (the gateway's ACL check) — the
        hottest read path must not pay two identical dir_gets."""
        if meta is None:
            meta = self.head_object(bucket, key)
        manifest = meta.get("multipart")
        if manifest:
            # stitch parts in part-number order (reference RGWGetObj
            # iterating the RGWObjManifest)
            body = b"".join(
                bytes(self.data.read(
                    _part_oid(bucket, manifest["upload_id"], num), size))
                for num, size in manifest["parts"])
            return body, meta
        if meta.get("version_id"):
            body = self.data.read(
                _version_oid(bucket, meta["version_id"], key),
                meta["size"])
        else:
            body = self.data.read(_data_oid(bucket, key), meta["size"])
        return body, meta

    def delete_object(self, bucket: str, key: str) -> None:
        bmeta = self._bucket_meta(bucket)
        if bmeta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        cur = self._current_meta(bucket, key, bmeta=bmeta)
        if cur is None and bmeta.get("versioning") != "Enabled":
            # validate BEFORE logging (both plain and Suspended paths
            # 404 on an absent key): a failed op must not feed the
            # mod-log or the usage/stats ledgers
            raise RGWError(404, "NoSuchKey", key)
        owner = (cur or {}).get("owner") or bmeta.get("owner")
        self._modlog("sync", bucket, key)
        if bmeta.get("versioning") == "Enabled":
            # versioned delete = insert a delete marker as the new
            # current; nothing is destroyed (reference delete markers)
            self._archive_null_version(bucket, key, bmeta=bmeta)
            vid = self._new_version_id()
            meta = {"size": 0, "etag": "", "mtime": time.time(),
                    "delete_marker": True}
            self._archive_version(bucket, key, meta, vid, bmeta=bmeta)
            try:
                self.index.rm(bucket, "index", key, bmeta=bmeta)
            except RadosError as e:
                self._not_found(e)
            if cur is not None:
                self._user_stats(owner, bucket, -1,
                                 -cur.get("size", 0))
            self._usage(owner, "delete_obj", bucket, key,
                        (cur or {}).get("size", 0))
            self._publish(bucket, key,
                          "s3:ObjectRemoved:DeleteMarkerCreated",
                          bmeta=bmeta)
            self._modlog("sync", bucket, key)   # post-success
            return
        suspended = bool(bmeta.get("versioning"))
        reap = self._displaced_manifests(bucket, key, suspended,
                                         cur=cur)
        try:
            self.index.rm(bucket, "index", key, bmeta=bmeta)
        except RadosError as e:
            self._not_found(e)
            raise RGWError(404, "NoSuchKey", key) from e
        if cur is not None:
            self._user_stats(owner, bucket, -1, -cur.get("size", 0))
        self._usage(owner, "delete_obj", bucket, key,
                    (cur or {}).get("size", 0))
        self._publish(bucket, key, "s3:ObjectRemoved:Delete",
                      bmeta=bmeta)
        if suspended:
            # S3: DELETE on a Suspended bucket replaces the null
            # version with a null DELETE MARKER (the displaced null
            # data is destroyed; version_id'd rows survive untouched)
            self._archive_version(bucket, key, {
                "size": 0, "etag": "", "mtime": time.time(),
                "delete_marker": True}, "null", bmeta=bmeta)
        for m in reap:
            self._reap_manifest(bucket, m)
        try:
            self.data.remove(_data_oid(bucket, key))
        except RadosError:
            pass
        self._modlog("sync", bucket, key)       # post-success

    def copy_object(self, src_bucket: str, src_key: str,
                    dst_bucket: str, dst_key: str,
                    extra: dict | None = None) -> dict:
        """Server-side copy (reference RGWCopyObj, rgw_op.h:1500s):
        the client never sees the bytes.  A multipart source is
        materialized into a plain destination object (the reference
        copies manifests tail-first; one data object is the honest
        equivalent at this scale)."""
        body, _meta = self.get_object(src_bucket, src_key)
        etag = self.put_object(dst_bucket, dst_key, bytes(body),
                               extra=extra)
        return {"etag": etag, "mtime": time.time()}

    # -- multipart uploads (reference rgw_op.h:1716-1754) -------------------

    def init_multipart(self, bucket: str, key: str) -> str:
        self._require_bucket(bucket)
        import os
        upload_id = os.urandom(16).hex()
        self._cls(self.meta, f"uploads.{bucket}", "dir_add", {
            "key": f"{key}\x00{upload_id}",
            "meta": {"key": key, "initiated": time.time()}})
        self._cls(self.meta, f"parts.{bucket}.{upload_id}", "dir_init")
        return upload_id

    def _require_upload(self, bucket: str, key: str,
                        upload_id: str) -> None:
        try:
            self._cls(self.meta, f"uploads.{bucket}", "dir_get",
                      {"key": f"{key}\x00{upload_id}"})
        except RadosError as e:
            self._not_found(e)
            raise RGWError(404, "NoSuchUpload", upload_id) from e

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_num: int, body: bytes) -> str:
        if not 1 <= part_num <= 10000:
            raise RGWError(400, "InvalidArgument",
                           f"partNumber {part_num} not in 1..10000")
        self._require_upload(bucket, key, upload_id)
        etag = hashlib.md5(body).hexdigest()
        self.data.write_full(_part_oid(bucket, upload_id, part_num), body)
        self._cls(self.meta, f"parts.{bucket}.{upload_id}", "dir_add", {
            "key": f"{part_num:05d}",
            "meta": {"size": len(body), "etag": etag,
                     "mtime": time.time()}})
        return etag

    def list_parts(self, bucket: str, key: str, upload_id: str
                   ) -> list[tuple[int, dict]]:
        self._require_upload(bucket, key, upload_id)
        out = json.loads(self._cls(
            self.meta, f"parts.{bucket}.{upload_id}", "dir_list",
            {"max": 10000}).decode())
        return [(int(k), m) for k, m in out["entries"]]

    def list_multipart_uploads(self, bucket: str
                               ) -> list[tuple[str, str, dict]]:
        self._require_bucket(bucket)
        try:
            out = json.loads(self._cls(
                self.meta, f"uploads.{bucket}", "dir_list",
                {"max": 10000}).decode())
        except RadosError as e:
            self._not_found(e)
            return []
        rows = []
        for k, m in out["entries"]:
            key, _, upload_id = k.rpartition("\x00")
            rows.append((key, upload_id, m))
        return rows

    def complete_multipart(self, bucket: str, key: str, upload_id: str,
                           parts: list[tuple[int, str]],
                           extra: dict | None = None) -> str:
        """parts = [(part_num, etag), ...] from the client's
        CompleteMultipartUpload body.  Validates against what was
        uploaded (reference RGWCompleteMultipart::execute), writes the
        manifest index entry, reaps the upload bookkeeping.  The
        combined ETag is md5-of-binary-part-md5s + "-N" (S3
        convention)."""
        self._require_upload(bucket, key, upload_id)
        if not parts:
            raise RGWError(400, "MalformedXML", "no parts listed")
        have = dict(self.list_parts(bucket, key, upload_id))
        last = 0
        md5cat = b""
        manifest = []
        total = 0
        for num, etag in parts:
            if num <= last:
                raise RGWError(400, "InvalidPartOrder",
                               f"part {num} after {last}")
            last = num
            meta = have.get(num)
            if meta is None or meta["etag"] != etag.strip('"'):
                raise RGWError(400, "InvalidPart",
                               f"part {num} not uploaded or etag "
                               f"mismatch")
            md5cat += bytes.fromhex(meta["etag"])
            manifest.append([num, meta["size"]])
            total += meta["size"]
        bmeta = self._bucket_meta(bucket) or {}
        owner = (extra or {}).get("owner") or bmeta.get("owner")
        cur = self._current_meta(bucket, key, bmeta=bmeta)
        cur_owner = (cur or {}).get("owner") or bmeta.get("owner")
        same = (cur is None or cur_owner == owner)
        q_obj = (0 if cur else 1) if same else 1
        q_bytes = (total - (cur or {}).get("size", 0)) if same else total
        token = self._quota_gate(owner, q_obj, q_bytes)
        try:
            self._modlog("sync", bucket, key)   # validated: will mutate
            etag = f"{hashlib.md5(md5cat).hexdigest()}-{len(parts)}"
            obj_meta = {"size": total, "etag": etag,
                        "mtime": time.time(),
                        "multipart": {"upload_id": upload_id,
                                      "parts": manifest},
                        **(extra or {})}
            if bmeta.get("versioning") == "Enabled":
                # S3: CompleteMultipartUpload on a versioned bucket
                # mints a new object version like any PUT; the
                # overwritten current survives as a version row (its
                # manifest stays referenced by that row — never reaped
                # here)
                self._archive_null_version(bucket, key, bmeta=bmeta)
                vid = self._new_version_id()
                self._archive_version(bucket, key, obj_meta, vid,
                                      bmeta=bmeta)
                self.index.add(bucket, "index", key,
                               {**obj_meta, "version_id": vid},
                               bmeta=bmeta)
            else:
                suspended = bool(bmeta.get("versioning"))
                reap = self._displaced_manifests(bucket, key, suspended)
                self.index.add(bucket, "index", key, obj_meta,
                               bmeta=bmeta)
                if suspended:
                    # like put_object: the complete replaces the null
                    # version on a Suspended bucket
                    self._archive_version(
                        bucket, key, {**obj_meta, "null_data": True},
                        "null", bmeta=bmeta)
                for m in reap:
                    self._reap_manifest(bucket, m)
            # unreferenced parts (uploaded but not listed)
            listed = {num for num, _ in parts}
            for num in have:
                if num not in listed:
                    try:
                        self.data.remove(
                            _part_oid(bucket, upload_id, num))
                    except RadosError:
                        pass
            self._rm_upload_bookkeeping(bucket, key, upload_id)
            self._account_overwrite(bucket, key, cur, cur_owner, owner,
                                    total)
            self._publish(bucket, key,
                          "s3:ObjectCreated:CompleteMultipartUpload",
                          total, bmeta=bmeta)
            self._modlog("sync", bucket, key)   # post-success
            return etag
        finally:
            self._quota_release(owner, token)

    def abort_multipart(self, bucket: str, key: str,
                        upload_id: str) -> None:
        self._require_upload(bucket, key, upload_id)
        for num, _meta in self.list_parts(bucket, key, upload_id):
            try:
                self.data.remove(_part_oid(bucket, upload_id, num))
            except RadosError:
                pass
        self._rm_upload_bookkeeping(bucket, key, upload_id)

    def _rm_upload_bookkeeping(self, bucket: str, key: str,
                               upload_id: str) -> None:
        try:
            self._cls(self.meta, f"uploads.{bucket}", "dir_rm",
                      {"key": f"{key}\x00{upload_id}"})
        except RadosError:
            pass
        try:
            self.meta.remove(f"parts.{bucket}.{upload_id}")
        except RadosError:
            pass

    @staticmethod
    def _prefix_successor(p: str) -> str | None:
        """Smallest string ordering AFTER every string prefixed by p
        (None when no such string exists)."""
        while p and p[-1] == "\U0010ffff":
            p = p[:-1]
        if not p:
            return None
        return p[:-1] + chr(ord(p[-1]) + 1)

    def list_objects(self, bucket: str, prefix: str = "",
                     marker: str = "", max_keys: int = 1000,
                     delimiter: str = "", resume: str = ""
                     ) -> tuple[list, list[str], bool, str]:
        """(contents, common_prefixes, truncated, resume_point).  With
        a delimiter, keys sharing prefix+...+delimiter roll up into one
        CommonPrefixes entry (reference RGWListBucket delimiter
        handling — what `aws s3 ls` folder listings are made of).
        `marker` (StartAfter) is exclusive; `resume` (continuation
        token) is an INCLUSIVE lower bound and takes precedence.  The
        returned resume_point feeds the next request's `resume`:
        key+"\\0" past an emitted key, or the prefix successor past a
        rolled-up folder — so folders cost one index probe each (not a
        walk of every key underneath) and progress is guaranteed for
        ANY legal key bytes (no sentinel-collision livelock).

        Sharded buckets list through the merged cursor: one bounded
        page per shard in flight, entries in global key order — the
        truncation invariant (never present a truncated page as
        complete) holds per shard and merged, because `truncated` is
        literally "the cursor still holds an entry".  A truncated
        page stashes its live cursor under the returned resume token;
        the follow-up request continues it (buffered shard pages
        intact) instead of paying one re-seek dir_list per shard."""
        self._require_bucket(bucket)
        page = min(max_keys, 1000) + 1
        lay = self.index.read_layout(bucket)
        ckey = (bucket, prefix, marker, delimiter, page)
        mcur = self._take_cursor((*ckey, resume), lay) if resume \
            else None
        if mcur is None:
            mcur = self.index.cursor(bucket, "index", prefix=prefix,
                                     marker=marker, resume=resume,
                                     page=page, lay=lay)
        if not delimiter:
            entries: list[tuple[str, dict]] = []
            while len(entries) < max_keys:
                ent = mcur.next()
                if ent is None:
                    break
                entries.append((ent[0], ent[1]))
            nm = entries[-1][0] + "\x00" if entries else ""
            trunc = mcur.peek() is not None
            if trunc and nm:
                self._stash_cursor((*ckey, nm), lay, mcur)
            return entries, [], trunc, nm
        contents: list[tuple[str, dict]] = []
        prefixes: list[str] = []
        cur = resume
        while True:
            if len(contents) + len(prefixes) >= max_keys:
                # page budget reached: truncated iff anything remains
                # at/after the resume point (the old max:1 probe is
                # now just a peek at the merged stream)
                trunc = mcur.peek() is not None
                if trunc and cur:
                    self._stash_cursor((*ckey, cur), lay, mcur)
                return contents, prefixes, trunc, cur
            ent = mcur.next()
            if ent is None:
                break
            k, m = ent
            rest = k[len(prefix):]
            d = rest.find(delimiter)
            if d >= 0:
                cp = prefix + rest[: d + len(delimiter)]
                prefixes.append(cp)
                succ = self._prefix_successor(cp)
                if succ is None:
                    break          # nothing can sort after the folder
                cur = succ
                # skip the whole folder in one hop on every shard
                mcur.seek(succ)
            else:
                contents.append((k, m))
                cur = k + "\x00"
        return contents, prefixes, False, cur

    # -- index shard admin (reference radosgw-admin bucket reshard /
    #    bucket limit check; rgw/reshard.py does the heavy lifting) --------

    def reshard_bucket(self, bucket: str, shards: int) -> dict:
        """Manual online reshard to `shards` (start dual-write, copy,
        cut over); returns the post-cutover status."""
        return self.resharder.reshard(bucket, shards)

    def reshard_status(self, bucket: str) -> dict:
        return self.resharder.status(bucket)

    def reshard_sweep(self) -> dict:
        """One autoscale/resume pass (mgr tick, gateway maintenance
        loop, or tests)."""
        return self.resharder.sweep()

    def bucket_stats(self, bucket: str) -> dict:
        """Shard layout + per-shard entry counts + live reshard
        marker + in-process per-shard op counters."""
        bmeta = self._bucket_meta(bucket)
        if bmeta is None:
            raise RGWError(404, "NoSuchBucket", bucket)
        lay = self.index.read_layout(bucket, bmeta)
        fill = self.index.shard_counts(bucket, bmeta=bmeta)
        return {"bucket": bucket, "shards": lay.shards,
                "gen": lay.gen, "objects": sum(fill.values()),
                "shard_fill": fill,
                "reshard": bmeta.get("reshard"),
                "perf": self.index.perf_dump(bucket)}

    def bucket_limit_check(self) -> list[dict]:
        """Per-bucket shard-fill report (reference `radosgw-admin
        bucket limit check`): objects per shard vs
        rgw_max_objs_per_shard, with OK / WARN (>50% of the reshard
        threshold) / OVER status."""
        max_objs = SCHEMA["rgw_max_objs_per_shard"].default
        out = []
        for bucket, bmeta in self.list_buckets():
            lay = self.index.read_layout(bucket, bmeta)
            count = self.index.count(bucket, bmeta=bmeta)
            per_shard = count / max(1, lay.shards)
            fill = per_shard / max_objs
            status = ("OVER" if per_shard > max_objs else
                      "WARN" if fill > 0.5 else "OK")
            out.append({"bucket": bucket, "shards": lay.shards,
                        "objects": count,
                        "objects_per_shard": round(per_shard, 1),
                        "fill_ratio": round(fill, 4),
                        "status": status})
        return out

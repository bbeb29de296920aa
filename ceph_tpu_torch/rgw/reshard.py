"""Online bucket resharding (reference RGWReshard, rgw_reshard.cc).

Protocol — three durable states, all riding the bucket-meta row (the
reshard marker is the reference's cls_rgw_bucket_instance_entry
RESHARD_IN_PROGRESS state on the bucket instance):

1. **dual** — `start()` stamps {"reshard": {"shards": M, "gen": G+1,
   "state": "dual", "progress": ...}} into the bucket meta.  From the
   moment a writer reads that meta, every index mutation lands on the
   OLD shard set (still authoritative; all reads come from it) AND
   the NEW one; deletes tombstone on the new side (cls_rgw dir_rm
   tombstone mode).  A grace dwell (rgw_reshard_grace_s) lets writers
   holding a pre-marker bucket meta finish their single-layout writes
   before any copying starts — their entries are then on the old
   shards, where the copier will find them.
2. **copy** — `run()` pages each old shard (dir_list) and applies the
   pages to the new layout with dir_merge if_absent: an entry the
   dual-writers already placed (newer) or tombstoned (deleted) is
   never overwritten or resurrected.  Progress (old shards fully
   copied, per plane) persists in the marker after every shard, so a
   killed daemon resumes where it stopped — and re-copying a
   half-copied shard is idempotent by the same if_absent rule.
3. **cutover** — one bucket-meta RMW under the store's meta lock
   flips "index" to the new layout and drops the marker.  Writers
   pick up the new meta on their next read; old shards are reaped and
   the new shards' tombstone rows cleaned (dir_reshard_clean).

The autoscaler (`sweep()`, driven by the mgr rgw_reshard module and
the gateway's maintenance loop) doubles the shard count to the next
power of two whenever entries/shard exceeds rgw_max_objs_per_shard —
the reference's dynamic resharding — and resumes any reshard left in
the dual state by a dead daemon.
"""

from __future__ import annotations

import json
import threading
import time

from ..common.options import SCHEMA
from ..common.util import next_pow2
from ..rados.client import RadosError
from .bucket_index import _Layout, shard_of

BUCKETS_OBJ = "buckets"


def _opt(name: str):
    return SCHEMA[name].default


class Resharder:
    def __init__(self, store):
        self.store = store
        self._mu = threading.Lock()     # one sweep/run at a time

    # -- admin surface ----------------------------------------------

    def status(self, bucket: str) -> dict:
        st = self.store
        bmeta = st._bucket_meta(bucket)
        if bmeta is None:
            from .store import RGWError
            raise RGWError(404, "NoSuchBucket", bucket)
        lay = _Layout.from_bmeta(bucket, bmeta)
        return {"bucket": bucket, "shards": lay.shards,
                "gen": lay.gen,
                "objects": st.index.count(bucket, bmeta=bmeta),
                "reshard": bmeta.get("reshard")}

    def start(self, bucket: str, shards: int) -> dict:
        """Enter the dual-write state (durable marker + new shard
        objects initialized).  Copy/cutover happen in run()."""
        from .store import RGWError
        st = self.store
        shards = int(shards)
        if shards < 1:
            raise RGWError(400, "InvalidArgument",
                           f"shard count {shards}")
        with st._bmeta_lock:
            bmeta = st._bucket_meta(bucket)
            if bmeta is None:
                raise RGWError(404, "NoSuchBucket", bucket)
            if bmeta.get("reshard"):
                raise RGWError(409, "OperationAborted",
                               f"{bucket}: reshard already in progress")
            old = _Layout.from_bmeta(bucket, bmeta)
            if shards == old.shards:
                raise RGWError(400, "InvalidArgument",
                               f"{bucket} already has {shards} shards")
            marker = {"shards": shards, "gen": old.gen + 1,
                      "state": "dual", "started": time.time(),
                      "progress": {"index": 0, "versions": 0}}
            bmeta["reshard"] = marker
            st._cls(st.meta, BUCKETS_OBJ, "dir_add",
                    {"key": bucket, "meta": bmeta})
        new = _Layout(bucket, shards, old.gen + 1)
        for plane in ("index", "versions"):
            for oid in new.oids(plane):
                st._cls(st.meta, oid, "dir_init")
        return marker

    def reshard(self, bucket: str, shards: int) -> dict:
        """Manual `bucket reshard`: start + run to completion."""
        self.start(bucket, shards)
        return self.run(bucket)

    # -- copy + cutover ----------------------------------------------

    def _progress(self, bucket: str, gen: int, plane: str,
                  done: int) -> None:
        """Durably record `done` old shards fully copied for `plane`
        (the resume point a revived daemon starts from)."""
        st = self.store
        with st._bmeta_lock:
            bmeta = st._bucket_meta(bucket)
            rs = (bmeta or {}).get("reshard")
            if not rs or rs.get("gen") != gen:
                return          # cut over or superseded meanwhile
            rs["progress"][plane] = done
            st._cls(st.meta, BUCKETS_OBJ, "dir_add",
                    {"key": bucket, "meta": bmeta})

    def _copy_shard(self, old_oid: str, bucket: str, new: _Layout,
                    plane: str, batch: int) -> int:
        """Page one old shard into the new layout.  Version rows
        route by PARENT key (everything left of the \\x00 separator)
        so a key's versions stay colocated."""
        st = self.store
        frm = ""
        copied = 0
        while True:
            try:
                out = json.loads(st._cls(
                    st.meta, old_oid, "dir_list",
                    {"from": frm, "max": batch}).decode())
            except RadosError as e:
                st._not_found(e)
                return copied   # legacy plane object never created
            entries = out["entries"]
            if not entries:
                return copied
            groups: dict[str, list] = {}
            for k, m in entries:
                route = k.split("\x00", 1)[0] if plane == "versions" \
                    else k
                oid = new.oid(plane, shard_of(route, new.shards))
                groups.setdefault(oid, []).append([k, m])
            for oid, ents in groups.items():
                copied += int(st._cls(
                    st.meta, oid, "dir_merge",
                    {"entries": ents, "if_absent": True}))
            frm = entries[-1][0] + "\x00"
            if not out["truncated"]:
                return copied

    def run(self, bucket: str) -> dict:
        """Copy + cutover for an in-progress (dual) reshard; safe to
        call again after a crash — progress resumes from the durable
        marker and re-copies are idempotent."""
        st = self.store
        bmeta = st._bucket_meta(bucket)
        rs = (bmeta or {}).get("reshard")
        if not rs or rs.get("state") != "dual":
            return self.status(bucket)
        gen = rs["gen"]
        old = _Layout.from_bmeta(bucket, bmeta)
        new = _Layout(bucket, rs["shards"], gen)
        # grace: writers that fetched bucket meta just before the
        # marker landed must drain before the copy snapshots old shards
        dwell = _opt("rgw_reshard_grace_s") - (
            time.time() - rs.get("started", 0.0))
        if dwell > 0:
            time.sleep(dwell)
        batch = _opt("rgw_reshard_batch")
        copied = 0
        for plane in ("index", "versions"):
            start_at = int(rs["progress"].get(plane, 0))
            oids = old.oids(plane)
            for i in range(start_at, len(oids)):
                copied += self._copy_shard(oids[i], bucket, new,
                                           plane, batch)
                self._progress(bucket, gen, plane, i + 1)
        # cutover: one meta RMW makes the new layout authoritative
        with st._bmeta_lock:
            bmeta = st._bucket_meta(bucket)
            rs2 = (bmeta or {}).get("reshard")
            if not rs2 or rs2.get("gen") != gen:
                return self.status(bucket)      # superseded
            bmeta["index"] = {"shards": new.shards, "gen": gen}
            del bmeta["reshard"]
            st._cls(st.meta, BUCKETS_OBJ, "dir_add",
                    {"key": bucket, "meta": bmeta})
        for plane in ("index", "versions"):
            for oid in new.oids(plane):
                try:
                    st._cls(st.meta, oid, "dir_reshard_clean")
                except RadosError as e:
                    st._not_found(e)
            for oid in old.oids(plane):
                try:
                    st.meta.remove(oid)
                except RadosError:
                    pass
        out = self.status(bucket)
        out["copied"] = copied
        return out

    # -- dynamic autoscaling ------------------------------------------

    def sweep(self) -> dict:
        """One maintenance pass (mgr tick / gateway loop): resume any
        interrupted reshard, then autoscale buckets whose per-shard
        entry count exceeds rgw_max_objs_per_shard.  Per-bucket
        RadosError is swallowed — a degraded cluster retries on the
        next tick from the durable marker."""
        if not self._mu.acquire(blocking=False):
            return {"skipped": "sweep already running"}
        try:
            stats = {"resumed": 0, "started": 0, "errors": 0}
            max_objs = _opt("rgw_max_objs_per_shard")
            cap = _opt("rgw_reshard_max_shards")
            for bucket, bmeta in self.store.list_buckets():
                try:
                    if (bmeta.get("reshard") or {}).get("state") \
                            == "dual":
                        self.run(bucket)
                        stats["resumed"] += 1
                        continue
                    lay = _Layout.from_bmeta(bucket, bmeta)
                    count = self.store.index.count(bucket, bmeta=bmeta)
                    if count <= lay.shards * max_objs:
                        continue
                    target = min(cap, next_pow2(
                        -(-count // max_objs)))
                    if target > lay.shards:
                        self.start(bucket, target)
                        self.run(bucket)
                        stats["started"] += 1
                except RadosError:
                    stats["errors"] += 1
            return stats
        finally:
            self._mu.release()

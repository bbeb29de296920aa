"""RBD image journal + mirror replay (rbd-mirror role).

Re-expresses the reference's journaling stack at reduced scope:
src/journal/ (an ordered, replayable event log in RADOS objects) +
librbd's journaling image feature (every mutation is recorded before
it is applied — write-ahead, src/librbd/journal/) + the rbd-mirror
daemon's replayer (src/tools/rbd_mirror/ImageReplayer: tail the
journal, apply events to a peer image, advance the commit position).

Layout: a journal header object ("rbd_journal.<image>") maintained by
the journal object class (cls/cls_journal.py — the same cls seam the
reference routes this through, src/cls/journal): atomic server-side
seq allocation, ordered listing, per-peer client commit positions, and
client-fenced trim.  Bulky write payloads live in per-entry data
objects so the header stays light.
"""

from __future__ import annotations

import errno
import json
import uuid

from ..rados.client import IoCtx, RadosError


def _journal_oid(image: str) -> str:
    return f"rbd_journal.{image}"


def _entry_data_oid(image: str, seq: int) -> str:
    return f"rbd_journal.{image}.{seq:016x}"


def _resolve_data_oid(image: str, event: dict, seq: int) -> str:
    """Payload object for an entry: the uuid oid recorded in the index
    row, or the legacy seq-derived name for pre-data_oid journals."""
    return event.get("data_oid") or _entry_data_oid(image, seq)


class Journal:
    """Ordered event log for one image (reference journal::Journaler)."""

    def __init__(self, ioctx: IoCtx, image: str):
        self.io = ioctx
        self.image = image
        self.oid = _journal_oid(image)
        self.io.execute(self.oid, "journal", "create", b"")
        self._registered: set[str] = set()   # client_register cache

    def _list(self, after_seq: int) -> list:
        """Full ordered [(seq, event)...] listing, following
        pagination."""
        out = []
        pos = after_seq
        while True:
            raw = self.io.execute(self.oid, "journal", "list",
                                  json.dumps({"after_seq": pos,
                                              "max": 4096}).encode())
            page = json.loads(raw.decode())
            out.extend(page["entries"])
            if not page["truncated"] or not page["entries"]:
                return out
            pos = page["entries"][-1][0]

    # -- recording (image side) ---------------------------------------------

    def append(self, event: dict, data: bytes = b"") -> int:
        """Record one event (write-ahead: call BEFORE applying).  The
        sequence number is allocated SERVER-SIDE in the same atomic
        class call that stores the index row, so concurrent journaling
        handles never collide.  The payload object is written FIRST,
        under a unique provisional oid carried in the index row's meta
        (``data_oid``): an index entry therefore always has its payload
        durable before it becomes visible to replayers.  A crash between
        the two writes leaves only an unreferenced data object (harmless
        orphan; the event was never recorded, and write-ahead means the
        image mutation never happened either)."""
        if not data:
            return int(self.io.execute(
                self.oid, "journal", "append",
                json.dumps({"entry": event}).encode()))
        doid = f"rbd_journal.{self.image}.data.{uuid.uuid4().hex}"
        self.io.write_full(doid, data)
        event = dict(event, data_len=len(data), data_oid=doid)
        try:
            return int(self.io.execute(
                self.oid, "journal", "append",
                json.dumps({"entry": event}).encode()))
        except Exception:
            # index write failed but we're still alive: reclaim the
            # would-be orphan (its random name is unreachable by trim)
            try:
                self.io.remove(doid)
            except RadosError:
                pass
            raise

    # -- replay (mirror side) -----------------------------------------------

    def get_position(self, peer: str) -> int:
        try:
            raw = self.io.execute(self.oid, "journal", "client_get",
                                  json.dumps({"id": peer}).encode())
        except RadosError:
            return -1
        return int(json.loads(raw.decode())["pos"])

    def set_position(self, peer: str, seq: int) -> None:
        if peer not in self._registered:     # idempotent; once per
            self.io.execute(                 # handle, not per event
                self.oid, "journal", "client_register",
                json.dumps({"id": peer, "pos": -1}).encode())
            self._registered.add(peer)
        self.io.execute(self.oid, "journal", "client_update",
                        json.dumps({"id": peer, "pos": seq}).encode())

    def entries_after(self, seq: int):
        """Yield (seq, event, data) in order for every entry > seq."""
        for eseq, event in self._list(after_seq=seq):
            data = b""
            if event.get("data_len"):
                doid = _resolve_data_oid(self.image, event, eseq)
                try:
                    data = self.io.read(doid, event["data_len"])
                except RadosError as e:
                    if e.errno != errno.ENOENT:
                        raise   # transient error: retry, don't skip
                    # Payload object GONE (not unreadable): only
                    # possible for an entry a concurrent trim is midway
                    # through removing, or a pre-fix journal that
                    # crashed in the old index-before-payload window.
                    # Either way the entry is not replayable and never
                    # will be — skip it rather than wedging every
                    # future replay at this seq.
                    continue
            yield eseq, event, data

    def trim_to(self, seq: int) -> None:
        """Drop entries every peer has replayed (reference journal
        trimming at the minimum commit position — and the class
        REFUSES a trim past the slowest registered client, so a lagging
        mirror can never lose unreplayed events).  The fenced cls trim
        runs FIRST; payload objects are deleted only after it succeeds
        (deleting them first would destroy data the fence just
        protected)."""
        doids = [(_resolve_data_oid(self.image, event, eseq))
                 for eseq, event in self._list(after_seq=-1)
                 if eseq <= seq and event.get("data_len")]
        self.io.execute(self.oid, "journal", "trim",
                        json.dumps({"to_seq": seq}).encode())
        for doid in doids:
            try:
                self.io.remove(doid)
            except RadosError:
                pass


class ImageReplayer:
    """rbd-mirror's per-image replayer: tail the source journal, apply
    events to the peer image, advance the commit position
    (reference tools/rbd_mirror/ImageReplayer.cc)."""

    def __init__(self, src_ioctx: IoCtx, image: str, dst_ioctx: IoCtx,
                 peer: str = "mirror"):
        from .image import RBD, Image
        self.journal = Journal(src_ioctx, image)
        self.peer = peer
        self.image = image
        rbd = RBD(dst_ioctx)
        try:
            self.dst = Image(dst_ioctx, image)
        except RadosError:
            src = Image(src_ioctx, image)
            rbd.create(image, src.size(),
                       order=src._header["order"])
            self.dst = Image(dst_ioctx, image)

    def replay(self) -> int:
        """Apply all new events; returns how many were replayed.  The
        commit position advances PER EVENT (reference commits per
        entry), so a mid-batch failure resumes exactly where it
        stopped instead of re-applying."""
        pos = self.journal.get_position(self.peer)
        applied = 0
        for seq, event, data in self.journal.entries_after(pos):
            self._apply(event, data)
            self.journal.set_position(self.peer, seq)
            applied += 1
        return applied

    def _apply(self, event: dict, data: bytes) -> None:
        import errno as _errno
        op = event["op"]
        if op == "write":
            self.dst.write(event["offset"], data)
        elif op == "resize":
            self.dst.resize(event["size"])
        elif op == "snap_create":
            try:
                self.dst.snap_create(event["snap"])
            except RadosError as e:
                if e.errno != _errno.EEXIST:   # idempotent re-apply
                    raise
        elif op == "snap_remove":
            try:
                self.dst.snap_remove(event["snap"])
            except RadosError as e:
                if e.errno != _errno.ENOENT:
                    raise
        else:
            raise RadosError(22, f"unknown journal op {op!r}")

"""RBD exclusive lock: single-writer ownership of an image.

Re-expresses reference src/librbd/ExclusiveLock.h + ManagedLock.h over
the cls_lock object class (reference src/cls/lock/), the way the
reference does it:

- the lock lives on the image header object (cls lock "rbd_lock",
  exclusive, one owner id per open handle)
- the owner WATCHES the header object; liveness of a contender's
  counterpart is judged by the OSD's live-watcher list (reference
  list_watchers-based break_lock decision in ManagedLock) — a crashed
  owner has no watcher and its lock is broken automatically
- stealing notifies the header; the previous owner's watch callback
  marks its handle fenced, so every subsequent mutation through it
  raises ESHUTDOWN instead of corrupting the image (the role of the
  reference's watch-invalidation + osdmap blacklisting; the
  in-flight-op window the reference closes with an OSD-side blacklist
  is documented as out of scope here)

Cooperative handoff (reference request_lock notify) is intentionally
not implemented: a live owner either blocks the contender (EBUSY) or
is fenced by an explicit steal.
"""

from __future__ import annotations

import errno
import json
import os

from ..rados.client import RadosError

LOCK_NAME = "rbd_lock"


class LockLost(RadosError):
    """The handle's exclusive lock was stolen; the handle is fenced."""

    def __init__(self, image: str):
        super().__init__(errno.ESHUTDOWN,
                         f"exclusive lock on {image} was stolen")


class ExclusiveLock:
    def __init__(self, ioctx, header_oid: str, image_name: str):
        self.io = ioctx
        self.header_oid = header_oid
        self.image_name = image_name
        self.owner_id = f"client.{os.urandom(8).hex()}"
        self.acquired = False
        self.lost = False
        self._watch_cookie: int | None = None

    # -- owner side ----------------------------------------------------------

    def _on_notify(self, _oid: str, payload: bytes) -> None:
        try:
            msg = json.loads(payload.decode())
        except ValueError:
            return
        if msg.get("event") == "acquired" and \
                msg.get("owner") != self.owner_id:
            # someone stole the lock: fence this handle
            self.lost = True
            self.acquired = False

    def _cls(self, method: str, payload: dict) -> bytes:
        return self.io.execute(self.header_oid, "lock", method,
                               json.dumps(payload).encode())

    def acquire(self, steal: bool = False) -> None:
        """Take the exclusive lock; break a dead owner's lock
        automatically; EBUSY against a live owner unless steal."""
        if self.acquired:
            return
        if self.lost:
            raise LockLost(self.image_name)
        # watch first: our own liveness marker must be in place before
        # the lock record exists (a contender probing in between would
        # otherwise break our fresh lock)
        if self._watch_cookie is None:
            self._watch_cookie = self.io.watch(self.header_oid,
                                              self._on_notify)
        req = {"name": LOCK_NAME, "owner": self.owner_id,
               "type": "exclusive",
               "entity": self.io.client.objecter.messenger.entity}
        try:
            try:
                self._cls("lock", req)
            except RadosError as e:
                if e.errno != errno.EBUSY:
                    raise
                # EBUSY: is the current owner alive?  Watchers other
                # than our own cookie count as the owner's presence.
                watchers = set(self.io.list_watchers(self.header_oid))
                watchers.discard(self._watch_cookie)
                if watchers and not steal:
                    raise RadosError(
                        errno.EBUSY,
                        f"image {self.image_name} is locked by a live "
                        f"client (steal to take over)") from e
                self._blacklist_owners()
                self._cls("break_lock", {})
                self._cls("lock", req)
        except Exception:
            # failed acquire must not leave our watcher behind: a
            # contender would count it as a live owner forever
            self.release()
            raise
        self.acquired = True
        # fence any previous owner's handle
        self.io.notify(self.header_oid, json.dumps(
            {"event": "acquired", "owner": self.owner_id}).encode())

    def _blacklist_owners(self) -> None:
        """Fence the old owner(s) at the OSDs BEFORE breaking the
        lock (reference ManagedLock: blacklist-on-break-lock closes
        the window where the fenced owner's already-sent ops land
        after the steal).  Waits until this client observes the
        blacklisting osdmap epoch so the break doesn't race the map."""
        client = self.io.client
        my_entity = client.objecter.messenger.entity
        try:
            info = json.loads(self._cls("get_info", {}).decode())
        except RadosError:
            return
        epoch = 0
        for owner, rec in (info.get("lockers") or {}).items():
            ent = (rec or {}).get("entity")
            if not ent or ent == my_entity:
                continue
            r, out = client.mon_command({
                "prefix": "osd blacklist add", "entity": ent})
            if r == 0:
                epoch = max(epoch, out.get("epoch", 0))
        # map barrier (librados wait_for_latest_osdmap role)
        import time
        deadline = time.time() + 10
        while epoch and client.objecter.osdmap.epoch < epoch and \
                time.time() < deadline:
            client.objecter.refresh_map()

    def check(self) -> None:
        """Raise LockLost if this handle was fenced."""
        if self.lost:
            raise LockLost(self.image_name)

    def release(self) -> None:
        if self.acquired:
            try:
                self._cls("unlock", {"owner": self.owner_id})
            except RadosError:
                pass
            self.acquired = False
        if self._watch_cookie is not None:
            try:
                self.io.unwatch(self.header_oid, self._watch_cookie)
            except RadosError:
                pass
            self._watch_cookie = None

    def lockers(self) -> dict:
        return json.loads(self._cls("get_info", {}).decode())["lockers"]

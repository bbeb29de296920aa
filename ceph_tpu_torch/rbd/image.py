"""RBD images: virtual block devices striped over RADOS objects.

Re-expresses the core of reference src/librbd/ (ImageCtx + the
ImageRequest -> ObjectRequest dispatch in io/): an image is a header
object (`rbd_header.<name>`: JSON size/order/snaps/parent) plus data
objects `rbd_data.<name>.<block#>`, each 2^order bytes; block I/O at
arbitrary offsets maps to per-object extents (reference
Striper::file_to_extents role).

Snapshots are RADOS self-managed snapshots (reference librbd snapshots
over rados selfmanaged snap contexts): snap_create allocates a snap id
from the mon and subsequent writes carry the image's SnapContext, so
the OSD clones objects copy-on-write — no data is copied at snap time.
Clones are layered images (reference parent/child layering): a child
records (parent image, parent snap); reads fall through to the parent
at that snap for blocks the child has never written, and the first
child write to such a block pulls the parent content (COW pull,
reference CopyupRequest).
"""

from __future__ import annotations

import errno
import json

from ..rados.client import IoCtx, RadosError

DEFAULT_ORDER = 22  # 4 MiB objects, the reference default


class RBD:
    """Image management (reference librbd.h rbd_create/list/remove/
    clone)."""

    def __init__(self, ioctx: IoCtx):
        self.io = ioctx

    def create(self, name: str, size: int,
               order: int = DEFAULT_ORDER) -> None:
        try:
            self.io.read(_header(name), 1)
            raise RadosError(errno.EEXIST, f"image {name} exists")
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
        header = {"size": size, "order": order, "snaps": [],
                  "snap_ids": {}, "parent": None}
        self.io.write_full(_header(name), json.dumps(header).encode())
        self._dir_add(name)

    def clone(self, parent: str, snap: str, child: str) -> None:
        """Layered clone from a parent snapshot (reference rbd clone;
        the snap plays the protected-snap role)."""
        pimg = Image(self.io, parent)
        if snap not in pimg._header.get("snap_ids", {}):
            raise RadosError(errno.ENOENT,
                             f"no snap {snap} on {parent}")
        try:
            self.io.read(_header(child), 1)
            raise RadosError(errno.EEXIST, f"image {child} exists")
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
        header = {"size": pimg.size(), "order": pimg._header["order"],
                  "snaps": [], "snap_ids": {},
                  "parent": [parent, pimg._header["snap_ids"][snap]]}
        self.io.write_full(_header(child), json.dumps(header).encode())
        self._dir_add(child)

    def list(self) -> list[str]:
        # images register in a directory object (reference rbd_directory)
        try:
            raw = self.io.read("rbd_directory", 0)
            return sorted(json.loads(raw.decode()))
        except RadosError:
            return []

    def _dir_add(self, name: str) -> None:
        names = set(self.list())
        names.add(name)
        self.io.write_full("rbd_directory",
                           json.dumps(sorted(names)).encode())

    def _dir_rm(self, name: str) -> None:
        names = set(self.list())
        names.discard(name)
        self.io.write_full("rbd_directory",
                           json.dumps(sorted(names)).encode())

    def remove(self, name: str) -> None:
        img = Image(self.io, name)
        nblocks = img._nblocks()
        for b in range(nblocks):
            try:
                self.io.remove(_data(name, b))
            except RadosError:
                pass
        from .object_map import _inval_oid, _map_oid
        for aux in (_map_oid(name), _inval_oid(name)):
            try:
                self.io.remove(aux)
            except RadosError:
                pass
        self.io.remove(_header(name))
        self._dir_rm(name)


def _header(name: str) -> str:
    return f"rbd_header.{name}"


def _data(name: str, block: int) -> str:
    return f"rbd_data.{name}.{block:016x}"


def _legacy_snap_data(name: str, snap: str, block: int) -> str:
    """Pre-COW full-copy snapshot object naming (kept readable so
    images snapshotted before the COW scheme still work)."""
    return f"rbd_data.{name}@{snap}.{block:016x}"


class Image:
    """Open image handle (reference ImageCtx + Image API).

    exclusive=True acquires the RBD exclusive lock on open (reference
    librbd/ExclusiveLock.h over cls_lock) and maintains the object map
    (reference ObjectMap.h): required for safe concurrent access — two
    lockless writers on one image corrupt it, exactly like the
    reference with the exclusive-lock feature disabled.  steal=True
    fences a live previous owner (its handle raises ESHUTDOWN on every
    later mutation)."""

    def __init__(self, ioctx: IoCtx, name: str,
                 journaling: bool = False, exclusive: bool = False,
                 steal: bool = False):
        # private IoCtx: the image's SnapContext/read-snap must not
        # leak onto other users of the caller's ioctx
        self.io = IoCtx(ioctx.client, ioctx.pool_id, ioctx.pool_name)
        self.name = name
        self._want_journal = journaling
        self._header = json.loads(
            self.io.read(_header(name), 0).decode())
        self._header.setdefault("snap_ids", {})
        self._header.setdefault("parent", None)
        # snapshots taken under the pre-COW scheme (full-copy objects,
        # no rados snap id) remain usable through their own paths
        self._legacy_snaps = {s for s in self._header["snaps"]
                              if s not in self._header["snap_ids"]}
        self._apply_snapc()
        self._parent: Image | None = None
        self._read_snap_id = 0
        self._legacy_read: str | None = None
        self._present_blocks: set[int] = set()   # copyup probe cache
        # exclusive lock + object map ride a snapc-free ioctx (their
        # objects must not be COW-cloned by image snapshots; the
        # reference keeps per-snap object maps — head-only here)
        self._lock = None
        self._omap = None
        self._closed = False
        self._lockless_checked = False
        if exclusive:
            from .exclusive_lock import ExclusiveLock
            from .object_map import ObjectMap
            aux_io = IoCtx(ioctx.client, ioctx.pool_id, ioctx.pool_name)
            self._lock = ExclusiveLock(aux_io, _header(name), name)
            self._lock.acquire(steal=steal)
            self._omap = ObjectMap(aux_io, name, self._nblocks())
            self._omap.load(self._probe_block)
        # journaling image feature (reference librbd journaling):
        # mutations are recorded write-ahead for rbd-mirror replay.
        # The journal rides a snapc-FREE ioctx (its objects must not be
        # COW-cloned by the image's snapshots) and is only created once
        # the header read proved the image exists.
        self._journal = None
        if self._want_journal:
            from .journal import Journal
            self._journal = Journal(
                IoCtx(ioctx.client, ioctx.pool_id, ioctx.pool_name),
                name)

    def _nblocks(self) -> int:
        return -(-self.size() // self.block_size)

    def _probe_block(self, block: int) -> bool:
        try:
            self.io.read(_data(self.name, block), 1, snap=0)
            return True
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
            return False

    def _live_omap(self):
        """The object map, but only while this handle legitimately
        owns it: a fenced handle consulting its stale map would
        fabricate zeros for blocks the new owner wrote."""
        if self._omap is None or self._lock is None:
            return None
        return self._omap if (self._lock.acquired and
                              not self._lock.lost) else None

    def _writable(self) -> None:
        """Mutation gate.  Exclusive handles: closed or fenced fail.
        Lockless handles (legacy clients): refused while a LIVE owner
        holds the lock (the reference blocks lockless writes when the
        exclusive-lock feature is on), and their first write flags the
        object map invalid so the next owner rebuilds instead of
        trusting stale state (reference FLAG_OBJECT_MAP_INVALID).
        The lock-presence probe runs once per handle — a lock taken
        AFTER this handle's first write is not seen, a documented gap
        vs the reference's dynamic lock acquisition."""
        if self._closed:
            raise RadosError(errno.EBADF,
                             f"image {self.name}: handle closed")
        if self._lock is not None:
            self._lock.check()
            if not self._lock.acquired:
                self._lock.acquire()
            return
        if self._lockless_checked:
            return
        from .exclusive_lock import ExclusiveLock
        from .object_map import invalidate
        aux = IoCtx(self.io.client, self.io.pool_id, self.io.pool_name)
        probe = ExclusiveLock(aux, _header(self.name), self.name)
        if probe.lockers() and aux.list_watchers(_header(self.name)):
            raise RadosError(
                errno.EBUSY,
                f"image {self.name} is exclusively locked; open with "
                f"exclusive=True")
        invalidate(aux, self.name)
        self._lockless_checked = True

    def close(self) -> None:
        self._closed = True
        if self._lock is not None:
            self._lock.release()

    def __enter__(self) -> "Image":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def du(self) -> int:
        """Bytes of allocated blocks (reference `rbd du` fast-diff):
        O(1) from the object map under the lock, probe otherwise."""
        omap = self._live_omap()
        if omap is not None:
            return omap.used_bytes(self.block_size)
        return sum(self.block_size for b in range(self._nblocks())
                   if self._probe_block(b))

    def lock_owners(self) -> list[str]:
        from .exclusive_lock import ExclusiveLock
        lk = self._lock
        if lk is None:
            aux = IoCtx(self.io.client, self.io.pool_id,
                        self.io.pool_name)
            lk = ExclusiveLock(aux, _header(self.name), self.name)
        return sorted(lk.lockers())

    @property
    def block_size(self) -> int:
        return 1 << self._header["order"]

    def size(self) -> int:
        return self._header["size"]

    def _save_header(self) -> None:
        self.io.write_full(_header(self.name),
                           json.dumps(self._header).encode())

    def _apply_snapc(self) -> None:
        ids = sorted(self._header["snap_ids"].values(), reverse=True)
        self.io.snapc = [ids[0], ids] if ids else None

    def _get_parent(self) -> "Image | None":
        if self._header["parent"] is None:
            return None
        if self._parent is None:
            pname, psnap = self._header["parent"]
            self._parent = Image(self.io, pname)
            self._parent._read_snap_id = psnap
        return self._parent

    def _read_block(self, block: int, boff: int, run: int) -> bytes:
        """One block's bytes at this image's read context, falling
        through to the parent for never-written clone blocks."""
        # head reads under the lock skip the OSD round-trip for blocks
        # the object map knows are absent (reference ObjectMap-aware
        # ObjectReadRequest)
        omap = self._live_omap()
        skip_probe = (omap is not None and self._read_snap_id == 0
                      and self._legacy_read is None and
                      not omap.object_may_exist(block))
        try:
            if skip_probe:
                raise RadosError(errno.ENOENT, "object map: absent")
            if self._legacy_read is not None:
                piece = self.io.read(
                    _legacy_snap_data(self.name, self._legacy_read,
                                      block), run, boff, snap=0)
            else:
                piece = self.io.read(_data(self.name, block), run, boff,
                                     snap=self._read_snap_id)
            return piece + b"\0" * (run - len(piece))
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
        parent = self._get_parent()
        if parent is not None and \
                block * self.block_size < parent.size():
            return parent._read_block(block, boff, run)
        return b"\0" * run

    # -- block I/O ----------------------------------------------------------

    def write(self, offset: int, data: bytes) -> int:
        if offset + len(data) > self.size():
            raise RadosError(errno.EINVAL, "write past end of image")
        self._writable()
        if self._journal is not None:
            self._journal.append({"op": "write", "offset": offset},
                                 bytes(data))
        bs = self.block_size
        pos = 0
        while pos < len(data):
            block, boff = divmod(offset + pos, bs)
            run = min(bs - boff, len(data) - pos)
            if run < bs:
                self._copyup(block)
            if self._omap is not None:
                self._omap.ensure_exists(block)   # write-ahead
            self.io.write(_data(self.name, block),
                          data[pos:pos + run], offset=boff)
            pos += run
        return len(data)

    def _copyup(self, block: int) -> None:
        """First partial write to a clone block pulls the parent's
        content (reference CopyupRequest).  A per-handle presence cache
        keeps steady-state writes to one probe total per block."""
        parent = self._get_parent()
        if parent is None:
            return
        if block in self._present_blocks:
            return
        omap = self._live_omap()
        if omap is not None and not omap.object_may_exist(block):
            pass                        # map says absent: skip probe
        else:
            try:
                self.io.read(_data(self.name, block), 1)
                self._present_blocks.add(block)
                return                  # child block already exists
            except RadosError as e:
                if e.errno != errno.ENOENT:
                    raise
        content = parent._read_block(block, 0, self.block_size)
        if content.rstrip(b"\0"):
            if self._omap is not None:
                self._omap.ensure_exists(block)
            self.io.write_full(_data(self.name, block), content)
        self._present_blocks.add(block)

    def _read_block_at(self, block: int, snapid: int) -> bytes:
        """One whole block read at an explicit snap context (the
        export-diff walk reads both sides of a snap pair)."""
        save = self._read_snap_id
        self._read_snap_id = snapid or 0
        try:
            return self._read_block(block, 0, self.block_size)
        finally:
            self._read_snap_id = save

    def export_diff(self, fh, from_snap: str | None = None,
                    to_snap: str | None = None) -> int:
        """Between-snap delta stream (reference rbd export-diff)."""
        from .diff import export_diff
        return export_diff(self, fh, from_snap, to_snap)

    def import_diff(self, fh) -> dict:
        """Apply a delta stream (reference rbd import-diff)."""
        self._writable()
        from .diff import import_diff
        return import_diff(self, fh)

    def read(self, offset: int, length: int) -> bytes:
        length = max(0, min(length, self.size() - offset))
        bs = self.block_size
        out = bytearray()
        pos = 0
        while pos < length:
            block, boff = divmod(offset + pos, bs)
            run = min(bs - boff, length - pos)
            out += self._read_block(block, boff, run)
            pos += run
        return bytes(out)

    def resize(self, new_size: int) -> None:
        self._writable()
        if self._journal is not None:
            self._journal.append({"op": "resize", "size": new_size})
        old_blocks = self._nblocks()
        new_blocks = -(-new_size // self.block_size)
        for b in range(new_blocks, old_blocks):
            try:
                self.io.remove(_data(self.name, b))
            except RadosError:
                pass
            self._present_blocks.discard(b)
        self._header["size"] = new_size
        self._save_header()
        if self._omap is not None:
            self._omap.resize(new_blocks)

    # -- snapshots (rados selfmanaged COW) -----------------------------------

    def snap_create(self, snap: str) -> None:
        if snap in self._header["snaps"]:
            raise RadosError(errno.EEXIST, f"snap {snap} exists")
        self._writable()
        if self._journal is not None:
            self._journal.append({"op": "snap_create", "snap": snap})
        snapid = self.io.selfmanaged_snap_create()
        self._header["snaps"].append(snap)
        self._header["snap_ids"][snap] = snapid
        # size at snap time: export-diff must bound its walk by the
        # snapshot's extent, not the (possibly resized) head's
        self._header.setdefault("snap_sizes", {})[snap] = self.size()
        self._save_header()
        self._apply_snapc()   # later writes COW against this snap

    def snap_list(self) -> list[str]:
        return list(self._header["snaps"])

    def snap_set(self, snap: str | None) -> None:
        """Route reads to a snapshot (reference rbd_snap_set); None
        returns to the head."""
        if snap is None:
            self._read_snap_id = 0
            self._legacy_read = None
        elif snap in self._legacy_snaps:
            self._legacy_read = snap
            self._read_snap_id = 0
        else:
            if snap not in self._header["snap_ids"]:
                raise RadosError(errno.ENOENT, f"no snap {snap}")
            self._read_snap_id = self._header["snap_ids"][snap]
            self._legacy_read = None

    def snap_rollback(self, snap: str) -> None:
        self._writable()
        if snap in self._legacy_snaps:
            snapid = None
        elif snap in self._header["snap_ids"]:
            snapid = self._header["snap_ids"][snap]
        else:
            raise RadosError(errno.ENOENT, f"no snap {snap}")
        bs = self.block_size
        nblocks = self._nblocks()
        for b in range(nblocks):
            try:
                if snapid is None:
                    data = self.io.read(
                        _legacy_snap_data(self.name, snap, b), 0)
                else:
                    data = self.io.read(_data(self.name, b), 0,
                                        snap=snapid)
            except RadosError as e:
                if e.errno != errno.ENOENT:
                    raise
                data = b""
            if data.rstrip(b"\0"):
                if self._omap is not None:
                    self._omap.ensure_exists(b)
                self.io.write(_data(self.name, b),
                              data.ljust(bs, b"\0")[:bs], offset=0)
            else:
                try:
                    self.io.remove(_data(self.name, b))
                except RadosError:
                    pass
                if self._omap is not None:
                    self._omap.mark_removed(b)
                self._present_blocks.discard(b)

    def snap_remove(self, snap: str) -> None:
        self._writable()
        if self._journal is not None:
            self._journal.append({"op": "snap_remove", "snap": snap})
        if snap in self._legacy_snaps:
            nblocks = self._nblocks()
            for b in range(nblocks):
                try:
                    self.io.remove(_legacy_snap_data(self.name, snap, b))
                except RadosError:
                    pass
            self._legacy_snaps.discard(snap)
            self._header["snaps"].remove(snap)
            self._save_header()
            return
        if snap not in self._header["snap_ids"]:
            raise RadosError(errno.ENOENT, f"no snap {snap}")
        snapid = self._header["snap_ids"][snap]
        self._header["snaps"].remove(snap)
        del self._header["snap_ids"][snap]
        self._save_header()
        self._apply_snapc()
        # report deletion so the OSD snap trimmer reclaims the clones
        try:
            self.io.selfmanaged_snap_remove(snapid)
        except RadosError:
            pass   # advisory; trim just won't run for this id yet

    def flatten(self) -> None:
        """Detach from the parent by copying up every missing block
        (reference rbd flatten)."""
        parent = self._get_parent()
        if parent is None:
            return
        self._writable()
        for b in range(self._nblocks()):
            self._copyup(b)
        self._header["parent"] = None
        self._parent = None
        self._save_header()

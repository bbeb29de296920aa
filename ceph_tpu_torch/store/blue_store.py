"""BlueStore-role raw-block ObjectStore.

Re-expresses the reference's production store architecture
(src/os/bluestore/BlueStore.h): object data lives on a raw block
"device" (one big file here) carved by an extent allocator, object
metadata (onodes) lives in a KV store, and writes follow BlueStore's
two paths:

* BIG / COW writes — the new object payload is written to FRESHLY
  allocated extents first, then the onode flips to them in one atomic
  KV commit and the old extents are released.  A crash before the KV
  commit leaves the old blob fully intact: no WAL, no double-write of
  data — the core BlueStore trick.
* SMALL in-place overwrites — the deferred-write machine
  (BlueStore.h:1504 STATE_DEFERRED_*): the payload is journaled INSIDE
  the same KV commit (a "D/" row) and applied to the block file after;
  mount replays unapplied rows.  Small overwrites cost one KV write +
  one in-place block write instead of a whole-blob COW.

Integrity at rest (bluestore_types.h:450 blob csum_data): every blob
carries crc32c per 4 KiB csum block, verified on EVERY read — bitrot
in the block file surfaces as EIO instead of silently corrupt data
(scrub repairs it from the other shards).  Blobs compress at rest
through the compressor subsystem when beneficial (reference blob
compression + min_alloc gating).

The allocator's free map is rebuilt from the onodes at mount (see
allocator.py).  Omap/xattrs ride the KV exactly like FileStore's.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Iterable

import numpy as np

from ..common import crc32c as _crc
from ..osd.types import ghobject_t, hobject_t, spg_t
from . import object_store as os_
from .allocator import Allocator
from .file_store import _esc
from .kv import KeyValueDB, WriteBatch, open_kv
from .object_store import ObjectStore, Transaction

MIN_ALLOC = 4096
CSUM_BLOCK = 4096
DEFERRED_MAX = 64 * 1024      # in-place path for writes <= this
COMPRESS_MIN_RATIO = 0.875    # keep compressed only if <= 7/8 of raw


def _csums(data: bytes) -> list[int]:
    return [_crc.crc32c(data[i:i + CSUM_BLOCK], 0xFFFFFFFF)
            for i in range(0, max(len(data), 1), CSUM_BLOCK)]


class BlueStore(ObjectStore):
    def __init__(self, path: str, compression: str | None = None):
        self.root = Path(path)
        self.kv: KeyValueDB | None = None
        self._lock = threading.RLock()
        self._block_f = None
        self._mounted = False
        self.alloc = Allocator(0, MIN_ALLOC)
        self._deferred_seq = 0
        # read-your-writes overlay for the transaction being prepared:
        # ops later in one txn (clone-after-setattr, double write) must
        # see the batch's pending mutations, which are not in the KV
        # until the single atomic submit
        self._overlay: dict | None = None
        self._content_overlay: dict | None = None
        self._txn_allocated: list | None = None
        self._wrote_blocks = False
        self.compression = compression
        self._compressor = None
        if compression:
            from ..compressor import create
            self._compressor = create(compression)

    # -- key scheme (FileStore-compatible shape, distinct kinds) ------------

    @staticmethod
    def _ckey(cid: spg_t) -> bytes:
        return f"C/{cid.pgid.pool}/{cid.pgid.seed}/{cid.shard}".encode()

    @staticmethod
    def _okey(cid: spg_t, oid: ghobject_t, kind: str,
              extra: str = "") -> bytes:
        h = oid.hobj
        return (f"{kind}/{cid.pgid.pool}/{cid.pgid.seed}/{cid.shard}/"
                f"{_esc(h.name)}/{_esc(h.key)}/{h.snap}/"
                f"{oid.generation}/{oid.shard}/{extra}").encode()

    # -- lifecycle ----------------------------------------------------------

    def mount(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        self.kv = open_kv(str(self.root / "kv"))
        block = self.root / "block"
        if not block.exists():
            block.write_bytes(b"")
        self._block_f = os.open(block, os.O_RDWR)
        # rebuild the allocator from authoritative onode metadata
        size = os.fstat(self._block_f).st_size
        self.alloc = Allocator(size, MIN_ALLOC)
        for _k, v in self.kv.iterate(b"N/"):
            onode = json.loads(v.decode())
            for off, length in onode["blob"]["extents"]:
                self.alloc.mark_used(off, length)
        self._replay_deferred()
        self._mounted = True

    def umount(self) -> None:
        with self._lock:
            if self._block_f is not None:
                os.fsync(self._block_f)
                os.close(self._block_f)
                self._block_f = None
            if self.kv:
                self.kv.compact()
                self.kv.close()
                self.kv = None
            self._mounted = False

    def _replay_deferred(self) -> None:
        """Apply deferred writes that committed in the KV but didn't
        reach the block file before a crash (idempotent: in-place
        writes of the same bytes)."""
        done = WriteBatch()
        for k, v in self.kv.iterate(b"D/"):
            rec = json.loads(v.decode())
            data = bytes.fromhex(rec["hex"])
            pos = 0
            for off, length in rec["extents"]:
                self._pwrite(off, data[pos:pos + length])
                pos += length
            done.rm(k)
            self._deferred_seq = max(self._deferred_seq,
                                     int(k.decode().split("/")[1]) + 1)
        if done.ops:
            os.fsync(self._block_f)
            self.kv.submit(done, sync=True)

    # -- block device helpers -----------------------------------------------

    def _pwrite(self, off: int, data: bytes) -> None:
        os.pwrite(self._block_f, data, off)

    def _pread(self, off: int, length: int) -> bytes:
        data = os.pread(self._block_f, length, off)
        return data.ljust(length, b"\x00")

    # -- onodes --------------------------------------------------------------

    def _kv_get(self, key: bytes) -> bytes | None:
        if self._overlay is not None and key in self._overlay:
            return self._overlay[key]
        return self.kv.get(key)

    def _kv_iter(self, prefix: bytes):
        rows = dict(self.kv.iterate(prefix))
        if self._overlay:
            for k, v in self._overlay.items():
                if k.startswith(prefix):
                    if v is None:
                        rows.pop(k, None)
                    else:
                        rows[k] = v
        return sorted(rows.items())

    def _bset(self, batch: WriteBatch, key: bytes, val: bytes) -> None:
        batch.set(key, val)
        if self._overlay is not None:
            self._overlay[key] = bytes(val)

    def _brm(self, batch: WriteBatch, key: bytes) -> None:
        batch.rm(key)
        if self._overlay is not None:
            self._overlay[key] = None

    def _onode(self, cid, oid) -> dict | None:
        raw = self._kv_get(self._okey(cid, oid, "N"))
        return json.loads(raw.decode()) if raw is not None else None

    def _read_blob(self, blob: dict) -> bytes:
        """Read + VERIFY a whole blob; raises IOError on csum mismatch
        (at-rest bitrot must never read back as data)."""
        stored = bytearray()
        for off, length in blob["extents"]:
            stored += self._pread(off, length)
        stored = bytes(stored[:blob["stored"]])
        for i, want in enumerate(blob["csum"]):
            got = _crc.crc32c(stored[i * CSUM_BLOCK:(i + 1) * CSUM_BLOCK],
                              0xFFFFFFFF)
            if got != want:
                raise IOError(
                    f"bluestore csum mismatch in csum block {i} "
                    f"(at-rest corruption)")
        if blob.get("alg"):
            from ..compressor import create
            stored = create(blob["alg"]).decompress(stored)
        return stored[:blob["raw"]]

    def _content(self, cid, oid) -> bytes:
        onode = self._onode(cid, oid)
        if onode is None:
            raise KeyError(f"no object {oid} in {cid}")
        okey = self._okey(cid, oid, "N")
        if self._content_overlay is not None and \
                okey in self._content_overlay:
            raw = self._content_overlay[okey]
            return raw.ljust(onode["size"], b"\x00")[:onode["size"]]
        if not onode["blob"]["extents"] and onode["blob"]["raw"] == 0:
            return b""
        return self._read_blob(onode["blob"]).ljust(onode["size"],
                                                    b"\x00")[:onode["size"]]

    def _write_blob(self, data: bytes) -> dict:
        """COW path: fresh extents + csums (+ compression when it
        pays); the caller commits the onode pointing here atomically."""
        raw_len = len(data)
        alg = None
        stored = data
        if self._compressor is not None and raw_len >= MIN_ALLOC:
            try:
                comp = self._compressor.compress(data)
                if len(comp) <= raw_len * COMPRESS_MIN_RATIO:
                    stored = comp
                    alg = self.compression
            except Exception:  # noqa: BLE001 - store uncompressed
                pass
        extents = self.alloc.allocate(max(len(stored), 1))
        if self._txn_allocated is not None:
            self._txn_allocated.extend(extents)
        self._wrote_blocks = True
        pos = 0
        for off, length in extents:
            self._pwrite(off, stored[pos:pos + length].ljust(length,
                                                             b"\x00"))
            pos += length
        return {"extents": extents, "stored": len(stored),
                "csum": _csums(stored), "raw": raw_len, "alg": alg}

    def _put_object(self, cid, oid, data: bytes, batch: WriteBatch,
                    released: list) -> None:
        old = self._onode(cid, oid)
        if old is not None:
            released.extend(old["blob"]["extents"])
        blob = self._write_blob(data)
        okey = self._okey(cid, oid, "N")
        self._bset(batch, okey, json.dumps(
            {"size": len(data), "blob": blob},
            separators=(",", ":")).encode())
        if self._content_overlay is not None:
            # supersede any earlier deferred content for this object
            self._content_overlay[okey] = bytes(data)

    def _try_deferred(self, cid, oid, op, batch: WriteBatch) -> bool:
        """Small aligned in-place overwrite within the existing
        uncompressed blob: journal payload in the KV commit, apply
        after (deferred-write machine)."""
        onode = self._onode(cid, oid)
        if onode is None or onode["blob"].get("alg"):
            return False
        end = op.offset + op.data.size
        if op.data.size > DEFERRED_MAX or end > onode["size"] or \
                onode["blob"]["raw"] != onode["blob"]["stored"]:
            return False
        # the touched csum blocks must be recomputed: read the blob,
        # patch, recompute only those blocks.  Earlier deferred writes
        # in this txn live in the content overlay, not on the device.
        okey = self._okey(cid, oid, "N")
        try:
            if self._content_overlay is not None and \
                    okey in self._content_overlay:
                content = bytearray(self._content_overlay[okey])
            else:
                content = bytearray(self._read_blob(onode["blob"]))
        except IOError:
            return False
        content[op.offset:end] = op.data.tobytes()
        first = op.offset // CSUM_BLOCK
        last = (end - 1) // CSUM_BLOCK
        for i in range(first, last + 1):
            onode["blob"]["csum"][i] = _crc.crc32c(
                bytes(content[i * CSUM_BLOCK:(i + 1) * CSUM_BLOCK]),
                0xFFFFFFFF)
        # map the logical range onto physical extents
        phys: list[tuple[int, int]] = []
        loff = 0
        for eoff, elen in onode["blob"]["extents"]:
            s = max(op.offset, loff)
            e = min(end, loff + elen)
            if s < e:
                phys.append((eoff + (s - loff), e - s))
            loff += elen
        seq = self._deferred_seq
        self._deferred_seq += 1
        self._bset(batch, f"D/{seq:016d}".encode(), json.dumps(
            {"extents": phys,
             "hex": op.data.tobytes().hex()}).encode())
        self._bset(batch, self._okey(cid, oid, "N"), json.dumps(
            onode, separators=(",", ":")).encode())
        self._pending_deferred.append((f"D/{seq:016d}".encode(), phys,
                                       op.data.tobytes()))
        if self._content_overlay is not None:
            self._content_overlay[okey] = bytes(content)
        return True

    # -- transactions -------------------------------------------------------

    def queue_transactions(self, cid: spg_t,
                           txns: Iterable[Transaction]) -> None:
        if not self._mounted:
            raise RuntimeError("store not mounted")
        callbacks = []
        with self._lock:
            if self.kv.get(self._ckey(cid)) is None:
                raise KeyError(f"no collection {cid}")
            batch = WriteBatch()
            released: list = []
            self._pending_deferred: list = []
            self._overlay = {}
            self._content_overlay = {}
            self._txn_allocated = []
            self._wrote_blocks = False
            try:
                for t in txns:
                    for op in t.ops:
                        self._prep(cid, op, batch, released)
                    callbacks.extend(t.on_commit)
            except Exception:
                # the batch dies with the exception: give back every
                # extent it allocated or the space leaks until remount
                self.alloc.release(self._txn_allocated)
                raise
            finally:
                self._overlay = None
                self._content_overlay = None
                self._txn_allocated = None
            # COW blob data must be DURABLE before the onode that
            # references it commits — otherwise a power loss after the
            # sync'd KV commit leaves a durable onode pointing at
            # never-persisted bytes (acked write lost as EIO)
            if self._wrote_blocks:
                os.fsync(self._block_f)
            self.kv.submit(batch, sync=True)
            # apply deferred in-place writes post-commit; the journal
            # rows are retired only after the block writes are durable
            # (same ordering _replay_deferred uses)
            if self._pending_deferred:
                done = WriteBatch()
                for key, phys, data in self._pending_deferred:
                    pos = 0
                    for off, length in phys:
                        self._pwrite(off, data[pos:pos + length])
                        pos += length
                    done.rm(key)
                os.fsync(self._block_f)
                self.kv.submit(done, sync=False)
            self.alloc.release(released)
        for cb in callbacks:
            cb()

    def _prep(self, cid, op, batch: WriteBatch, released: list) -> None:
        if isinstance(op, os_.OpTouch):
            if self._onode(cid, op.oid) is None:
                self._put_object(cid, op.oid, b"", batch, released)
        elif isinstance(op, os_.OpWrite):
            if op.data.size and self._try_deferred(cid, op.oid, op,
                                                   batch):
                return
            try:
                content = bytearray(self._content(cid, op.oid))
            except KeyError:
                content = bytearray()
            end = op.offset + op.data.size
            if len(content) < end:
                content.extend(bytes(end - len(content)))
            content[op.offset:end] = op.data.tobytes()
            self._put_object(cid, op.oid, bytes(content), batch,
                             released)
        elif isinstance(op, os_.OpZero):
            try:
                content = bytearray(self._content(cid, op.oid))
            except KeyError:
                content = bytearray()
            end = op.offset + op.length
            if len(content) < end:
                content.extend(bytes(end - len(content)))
            content[op.offset:end] = bytes(op.length)
            self._put_object(cid, op.oid, bytes(content), batch,
                             released)
        elif isinstance(op, os_.OpTruncate):
            try:
                content = bytearray(self._content(cid, op.oid))
            except KeyError:
                content = bytearray()
            if op.size <= len(content):
                content = content[:op.size]
            else:
                content.extend(bytes(op.size - len(content)))
            self._put_object(cid, op.oid, bytes(content), batch,
                             released)
        elif isinstance(op, os_.OpRemove):
            onode = self._onode(cid, op.oid)
            if onode is not None:
                released.extend(onode["blob"]["extents"])
            self._brm(batch, self._okey(cid, op.oid, "N"))
            self._brm(batch, self._okey(cid, op.oid, "H"))
            for kind in ("A", "O"):
                for k, _ in list(self._kv_iter(
                        self._okey(cid, op.oid, kind))):
                    self._brm(batch, k)
        elif isinstance(op, os_.OpSetAttrs):
            if self._onode(cid, op.oid) is None:
                self._put_object(cid, op.oid, b"", batch, released)
            for k, v in op.attrs.items():
                self._bset(batch, self._okey(cid, op.oid, "A", _esc(k)), v)
        elif isinstance(op, os_.OpRmAttr):
            self._brm(batch, self._okey(cid, op.oid, "A", _esc(op.name)))
        elif isinstance(op, os_.OpClone):
            try:
                content = self._content(cid, op.src)
            except KeyError:
                return
            dst_old = self._onode(cid, op.dst)
            if dst_old is not None:
                released.extend(dst_old["blob"]["extents"])
            self._put_object(cid, op.dst, content, batch, released)
            for kind in ("A", "O"):
                for k, v in list(self._kv_iter(
                        self._okey(cid, op.src, kind))):
                    suffix = k.decode().rsplit("/", 1)[-1]
                    self._bset(batch, self._okey(cid, op.dst, kind, suffix), v)
            hdr = self._kv_get(self._okey(cid, op.src, "H"))
            if hdr is not None:
                self._bset(batch, self._okey(cid, op.dst, "H"), hdr)
        elif isinstance(op, os_.OpRename):
            onode_raw = self._kv_get(self._okey(cid, op.src, "N"))
            if onode_raw is None:
                return
            self._bset(batch, self._okey(cid, op.dst, "N"), onode_raw)
            self._brm(batch, self._okey(cid, op.src, "N"))
            for kind in ("A", "O"):
                for k, v in list(self._kv_iter(
                        self._okey(cid, op.src, kind))):
                    suffix = k.decode().rsplit("/", 1)[-1]
                    self._bset(batch, self._okey(cid, op.dst, kind, suffix), v)
                    self._brm(batch, k)
            hdr = self._kv_get(self._okey(cid, op.src, "H"))
            if hdr is not None:
                self._bset(batch, self._okey(cid, op.dst, "H"), hdr)
                self._brm(batch, self._okey(cid, op.src, "H"))
        elif isinstance(op, os_.OpOmapSet):
            for k, v in op.kv.items():
                self._bset(batch, self._okey(cid, op.oid, "O", k.hex()), v)
        elif isinstance(op, os_.OpOmapRmKeys):
            for k in op.keys:
                self._brm(batch, self._okey(cid, op.oid, "O", k.hex()))
        elif isinstance(op, os_.OpOmapClear):
            for k, _ in list(self._kv_iter(
                    self._okey(cid, op.oid, "O"))):
                self._brm(batch, k)
            self._brm(batch, self._okey(cid, op.oid, "H"))
        elif isinstance(op, os_.OpOmapSetHeader):
            self._bset(batch, self._okey(cid, op.oid, "H"), op.data)
        else:
            raise TypeError(f"unknown transaction op {op!r}")

    # -- collections --------------------------------------------------------

    def create_collection(self, cid: spg_t) -> None:
        self.kv.set(self._ckey(cid), b"1")

    def remove_collection(self, cid: spg_t) -> None:
        self.kv.rm(self._ckey(cid))

    def list_collections(self) -> list[spg_t]:
        from ..osd.types import pg_t
        out = []
        for k, _ in self.kv.iterate(b"C/"):
            _, pool, seed, shard = k.decode().split("/")
            out.append(spg_t(pg_t(int(pool), int(seed)), int(shard)))
        return sorted(out)

    def collection_exists(self, cid: spg_t) -> bool:
        return self.kv.get(self._ckey(cid)) is not None

    # -- reads --------------------------------------------------------------

    def read(self, cid, oid, offset=0, length=None) -> np.ndarray:
        with self._lock:
            content = self._content(cid, oid)
        end = len(content) if length is None else min(
            len(content), offset + length)
        return np.frombuffer(content[offset:end], dtype=np.uint8)

    def stat(self, cid, oid) -> int:
        with self._lock:
            onode = self._onode(cid, oid)
        if onode is None:
            raise KeyError(f"no object {oid} in {cid}")
        return onode["size"]

    def exists(self, cid, oid) -> bool:
        with self._lock:
            return self._onode(cid, oid) is not None

    def getattr(self, cid, oid, name) -> bytes:
        with self._lock:
            raw = self._kv_get(self._okey(cid, oid, "A", _esc(name)))
        if raw is None:
            raise KeyError(name)
        return raw

    def getattrs(self, cid, oid) -> dict[str, bytes]:
        out = {}
        prefix = self._okey(cid, oid, "A")
        with self._lock:
            rows = self._kv_iter(prefix)
        for k, v in rows:
            out[self._unesc(k.decode()[len(prefix.decode()):])] = v
        return out

    def omap_get(self, cid, oid) -> dict[bytes, bytes]:
        out = {}
        prefix = self._okey(cid, oid, "O")
        with self._lock:
            rows = self._kv_iter(prefix)
        for k, v in rows:
            out[bytes.fromhex(k.decode()[len(prefix.decode()):])] = v
        return out

    def omap_get_header(self, cid, oid) -> bytes:
        with self._lock:
            return self._kv_get(self._okey(cid, oid, "H")) or b""

    def list_objects(self, cid) -> list[ghobject_t]:
        out = []
        prefix = self._ckey(cid).replace(b"C/", b"N/", 1) + b"/"
        with self._lock:
            rows = list(self.kv.iterate(prefix))
        for k, _ in rows:
            parts = k.decode().split("/")
            name = self._unesc(parts[4])
            key = self._unesc(parts[5])
            h = hobject_t(pool=int(parts[1]), name=name, key=key,
                          snap=int(parts[6]))
            out.append(ghobject_t(h, int(parts[7]), int(parts[8])))
        return sorted(out)

    @staticmethod
    def _unesc(s: str) -> str:
        from .file_store import FileStore
        return FileStore._unesc(s)

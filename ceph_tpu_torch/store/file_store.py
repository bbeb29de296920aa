"""FileStore: durable ObjectStore with a write-ahead journal.

Fills the role of the reference's production stores (src/os/bluestore/
for the architecture: data on the device + metadata in a KV with WAL
atomicity; src/os/filestore/ for the file-per-object layout): every
transaction batch is serialized (the messenger's wire form reused),
crc-protected, appended to the journal and fsync'd BEFORE being applied
— so a crash at any point replays to a consistent state (reference
BlueStore deferred/WAL semantics, BlueStore.h:1504 STATE_DEFERRED_*).

Layout under the store root:
  journal.log              WAL of pending transaction batches
  kv/                      LsmDB: xattrs, omap, object index
  objects/<coll>/<name>    object data files

Object data rides files; everything else rides the KV — the same split
BlueStore makes between the block device and RocksDB.
"""

from __future__ import annotations

import os
import struct
import threading
from pathlib import Path
from typing import Iterable

import numpy as np

from ..common import crc32c as _crc
from ..osd.types import ghobject_t, hobject_t, spg_t
from . import object_store as os_
from .kv import KeyValueDB, WriteBatch, open_kv
from .object_store import ObjectStore, Transaction


def _esc(s: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else f"%{ord(c):02x}"
                   for c in s)


class FileStore(ObjectStore):
    def __init__(self, path: str):
        self.root = Path(path)
        self.journal_path = self.root / "journal.log"
        self.kv: KeyValueDB | None = None
        self._lock = threading.RLock()
        self._journal_f = None
        self._mounted = False

    # -- key scheme ---------------------------------------------------------

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

    def _data_path(self, cid: spg_t, oid: ghobject_t) -> Path:
        d = self.root / "objects" / \
            f"{cid.pgid.pool}.{cid.pgid.seed}.{cid.shard}"
        d.mkdir(parents=True, exist_ok=True)
        h = oid.hobj
        return d / f"{_esc(h.name)}.{h.snap}.{oid.generation}.{oid.shard}"

    # -- lifecycle ----------------------------------------------------------

    def mount(self) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        self.kv = open_kv(str(self.root / "kv"))
        self._replay_journal()
        self._journal_f = open(self.journal_path, "ab")
        self._mounted = True

    def umount(self) -> None:
        with self._lock:
            if self._journal_f:
                self._journal_f.close()
                self._journal_f = None
            if self.kv:
                self.kv.compact()
                self.kv.close()
                self.kv = None
            self._mounted = False

    # -- journal ------------------------------------------------------------

    def _journal_append(self, payload: bytes) -> None:
        head = struct.pack("<II", len(payload),
                           _crc.crc32c(payload, 0xFFFFFFFF))
        self._journal_f.write(head + payload)
        self._journal_f.flush()
        os.fsync(self._journal_f.fileno())

    def _replay_journal(self) -> None:
        if not self.journal_path.exists():
            return
        import json
        from ..msg.messages import txn_from_wire
        with open(self.journal_path, "rb") as f:
            while True:
                head = f.read(8)
                if len(head) < 8:
                    break
                ln, crc = struct.unpack("<II", head)
                body = f.read(ln)
                if len(body) < ln or _crc.crc32c(body, 0xFFFFFFFF) != crc:
                    break  # torn tail
                rec = json.loads(body.decode())
                cid = spg_t.__new__(spg_t)
                from ..osd.types import pg_t
                object.__setattr__(cid, "pgid",
                                   pg_t(rec["cid"][0], rec["cid"][1]))
                object.__setattr__(cid, "shard", rec["cid"][2])
                txn = txn_from_wire(rec["ops"],
                                    bytes.fromhex(rec["blob"]))
                self._apply_txn(cid, txn)
        # applied everything durable: truncate the journal
        open(self.journal_path, "wb").close()

    # -- transactions -------------------------------------------------------

    def queue_transactions(self, cid: spg_t,
                           txns: Iterable[Transaction]) -> None:
        import json
        from ..msg.messages import txn_to_wire
        if not self._mounted:
            raise RuntimeError("store not mounted")
        txns = list(txns)
        callbacks = []
        with self._lock:
            if self.kv.get(self._ckey(cid)) is None:
                raise KeyError(f"no collection {cid}")
            for t in txns:
                ops, blob = txn_to_wire(t)
                rec = json.dumps({
                    "cid": [cid.pgid.pool, cid.pgid.seed, cid.shard],
                    "ops": ops, "blob": blob.hex()}).encode()
                self._journal_append(rec)      # durable intent first
                self._apply_txn(cid, t)        # then apply
                callbacks.extend(t.on_commit)
        for cb in callbacks:
            cb()

    def _apply_txn(self, cid: spg_t, txn: Transaction) -> None:
        for op in txn.ops:
            self._apply(cid, op)

    # -- op application -----------------------------------------------------

    def _size(self, cid, oid) -> int | None:
        raw = self.kv.get(self._okey(cid, oid, "S"))
        return None if raw is None else int(raw)

    def _set_size(self, batch, cid, oid, size: int) -> None:
        batch.set(self._okey(cid, oid, "S"), str(size).encode())

    def _apply(self, cid: spg_t, op) -> None:
        b = WriteBatch()
        if isinstance(op, os_.OpTouch):
            if self._size(cid, op.oid) is None:
                self._data_path(cid, op.oid).write_bytes(b"")
                self._set_size(b, cid, op.oid, 0)
        elif isinstance(op, os_.OpWrite):
            path = self._data_path(cid, op.oid)
            size = self._size(cid, op.oid)
            mode = "r+b" if (size is not None and path.exists()) else "wb"
            with open(path, mode) as f:
                f.seek(op.offset)
                f.write(op.data.tobytes())
                f.flush()
                os.fsync(f.fileno())
            new_size = max(size or 0, op.offset + op.data.size)
            self._set_size(b, cid, op.oid, new_size)
        elif isinstance(op, os_.OpZero):
            path = self._data_path(cid, op.oid)
            size = self._size(cid, op.oid) or 0
            with open(path, "r+b" if path.exists() else "wb") as f:
                f.seek(op.offset)
                f.write(bytes(op.length))
            self._set_size(b, cid, op.oid,
                           max(size, op.offset + op.length))
        elif isinstance(op, os_.OpTruncate):
            path = self._data_path(cid, op.oid)
            if not path.exists():
                path.write_bytes(b"")
            with open(path, "r+b") as f:
                f.truncate(op.size)
            self._set_size(b, cid, op.oid, op.size)
        elif isinstance(op, os_.OpRemove):
            path = self._data_path(cid, op.oid)
            if path.exists():
                path.unlink()
            b.rm(self._okey(cid, op.oid, "S"))
            b.rm(self._okey(cid, op.oid, "H"))
            for k, _ in list(self.kv.iterate(
                    self._okey(cid, op.oid, "A"))):
                b.rm(k)
            for k, _ in list(self.kv.iterate(
                    self._okey(cid, op.oid, "O"))):
                b.rm(k)
        elif isinstance(op, os_.OpSetAttrs):
            if self._size(cid, op.oid) is None:
                self._data_path(cid, op.oid).touch()
                self._set_size(b, cid, op.oid, 0)
            for k, v in op.attrs.items():
                b.set(self._okey(cid, op.oid, "A", _esc(k)), v)
        elif isinstance(op, os_.OpRmAttr):
            b.rm(self._okey(cid, op.oid, "A", _esc(op.name)))
        elif isinstance(op, os_.OpClone):
            src = self._data_path(cid, op.src)
            if src.exists():
                self._data_path(cid, op.dst).write_bytes(
                    src.read_bytes())
                self._set_size(b, cid, op.dst,
                               self._size(cid, op.src) or 0)
                for kind in ("A", "O"):
                    for k, v in list(self.kv.iterate(
                            self._okey(cid, op.src, kind))):
                        suffix = k.decode().rsplit("/", 1)[-1]
                        b.set(self._okey(cid, op.dst, kind, suffix), v)
                hdr = self.kv.get(self._okey(cid, op.src, "H"))
                if hdr is not None:
                    b.set(self._okey(cid, op.dst, "H"), hdr)
        elif isinstance(op, os_.OpRename):
            src = self._data_path(cid, op.src)
            if src.exists():
                os.replace(src, self._data_path(cid, op.dst))
                self._set_size(b, cid, op.dst,
                               self._size(cid, op.src) or 0)
                b.rm(self._okey(cid, op.src, "S"))
                # attrs and omap travel with the object (generations
                # rely on rename preserving the hinfo xattr)
                for kind in ("A", "O"):
                    for k, v in list(self.kv.iterate(
                            self._okey(cid, op.src, kind))):
                        suffix = k.decode().rsplit("/", 1)[-1]
                        b.set(self._okey(cid, op.dst, kind, suffix), v)
                        b.rm(k)
                hdr = self.kv.get(self._okey(cid, op.src, "H"))
                if hdr is not None:
                    b.set(self._okey(cid, op.dst, "H"), hdr)
                    b.rm(self._okey(cid, op.src, "H"))
        elif isinstance(op, os_.OpOmapSet):
            for k, v in op.kv.items():
                b.set(self._okey(cid, op.oid, "O", k.hex()), v)
        elif isinstance(op, os_.OpOmapRmKeys):
            for k in op.keys:
                b.rm(self._okey(cid, op.oid, "O", k.hex()))
        elif isinstance(op, os_.OpOmapClear):
            for k, _ in list(self.kv.iterate(
                    self._okey(cid, op.oid, "O"))):
                b.rm(k)
            b.rm(self._okey(cid, op.oid, "H"))
        elif isinstance(op, os_.OpOmapSetHeader):
            b.set(self._okey(cid, op.oid, "H"), op.data)
        else:
            raise TypeError(f"unknown transaction op {op!r}")
        if b.ops:
            self.kv.submit(b, sync=False)  # journal already made it durable

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
        size = self._size(cid, oid)
        if size is None:
            raise KeyError(f"no object {oid} in {cid}")
        path = self._data_path(cid, oid)
        data = path.read_bytes() if path.exists() else b""
        if len(data) < size:
            data = data + bytes(size - len(data))
        end = size if length is None else min(size, offset + length)
        return np.frombuffer(data[offset:end], dtype=np.uint8)

    def stat(self, cid, oid) -> int:
        size = self._size(cid, oid)
        if size is None:
            raise KeyError(f"no object {oid} in {cid}")
        return size

    def exists(self, cid, oid) -> bool:
        return self._size(cid, oid) is not None

    def getattr(self, cid, oid, name) -> bytes:
        raw = self.kv.get(self._okey(cid, oid, "A", _esc(name)))
        if raw is None:
            raise KeyError(name)
        return raw

    def getattrs(self, cid, oid) -> dict[str, bytes]:
        out = {}
        prefix = self._okey(cid, oid, "A")
        for k, v in self.kv.iterate(prefix):
            out[self._unesc(k.decode()[len(prefix.decode()):])] = v
        return out

    def omap_get(self, cid, oid) -> dict[bytes, bytes]:
        out = {}
        prefix = self._okey(cid, oid, "O")
        for k, v in self.kv.iterate(prefix):
            out[bytes.fromhex(k.decode()[len(prefix.decode()):])] = v
        return out

    def omap_get_header(self, cid, oid) -> bytes:
        return self.kv.get(self._okey(cid, oid, "H")) or b""

    def list_objects(self, cid) -> list[ghobject_t]:
        out = []
        prefix = self._ckey(cid).replace(b"C/", b"S/", 1) + b"/"
        for k, _ in self.kv.iterate(prefix):
            parts = k.decode().split("/")
            # S/pool/seed/shard/name/key/snap/gen/oshard/
            name = self._unesc(parts[4])
            key = self._unesc(parts[5])
            h = hobject_t(pool=int(parts[1]), name=name, key=key,
                          snap=int(parts[6]))
            out.append(ghobject_t(h, int(parts[7]), int(parts[8])))
        return sorted(out)

    @staticmethod
    def _unesc(s: str) -> str:
        out = []
        i = 0
        while i < len(s):
            if s[i] == "%":
                out.append(chr(int(s[i + 1:i + 3], 16)))
                i += 3
            else:
                out.append(s[i])
                i += 1
        return "".join(out)

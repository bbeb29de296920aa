"""KeyValueDB abstraction + implementations.

Re-expresses reference src/kv/ (KeyValueDB.h + RocksDBStore/MemDB): a
prefixed key-value store with atomic write batches, backing store
metadata (and, in the reference, the entire mon store).  Implementations:

  MemDB — dict-backed (reference MemDB role; tests)
  LogDB — durable WAL + whole-file snapshot (kept for small stores and
          as a comparison point; O(total-keys) compaction)
  LsmDB — ceph_tpu's real engine (kv_lsm.py, the RocksDBStore role)
          is not ported yet: `open_kv` with a path raises, and so do
          the persistent stores that ride it.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from pathlib import Path

from ..common import crc32c as _crc


class WriteBatch:
    def __init__(self):
        self.ops: list[tuple] = []   # ("set", k, v) | ("rm", k)

    def set(self, key: bytes, value: bytes) -> None:
        self.ops.append(("set", bytes(key), bytes(value)))

    def rm(self, key: bytes) -> None:
        self.ops.append(("rm", bytes(key)))


class KeyValueDB:
    def get(self, key: bytes) -> bytes | None:
        raise NotImplementedError

    def submit(self, batch: WriteBatch, sync: bool = True) -> None:
        raise NotImplementedError

    def iterate(self, prefix: bytes = b""):
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        b = WriteBatch()
        b.set(key, value)
        self.submit(b)

    def rm(self, key: bytes) -> None:
        b = WriteBatch()
        b.rm(key)
        self.submit(b)

    def close(self) -> None:
        pass


class MemDB(KeyValueDB):
    def __init__(self):
        self._d: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def get(self, key):
        with self._lock:
            return self._d.get(bytes(key))

    def submit(self, batch, sync=True):
        with self._lock:
            for op in batch.ops:
                if op[0] == "set":
                    self._d[op[1]] = op[2]
                else:
                    self._d.pop(op[1], None)

    def iterate(self, prefix=b""):
        with self._lock:
            items = sorted((k, v) for k, v in self._d.items()
                           if k.startswith(prefix))
        yield from items


class LogDB(KeyValueDB):
    """WAL + snapshot durable KV."""

    MAGIC = b"KVL1"

    def __init__(self, path: str, compact_every: int = 4096):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.snap = self.dir / "snapshot.json"
        self.wal = self.dir / "wal.log"
        self._d: dict[bytes, bytes] = {}
        self._lock = threading.RLock()
        self._since_compact = 0
        self.compact_every = compact_every
        self._replay()
        self._wal_f = open(self.wal, "ab")

    # -- recovery -----------------------------------------------------------

    def _replay(self) -> None:
        if self.snap.exists():
            raw = json.loads(self.snap.read_text())
            self._d = {bytes.fromhex(k): bytes.fromhex(v)
                       for k, v in raw.items()}
        if self.wal.exists():
            good = 0
            with open(self.wal, "rb") as f:
                while True:
                    head = f.read(8)
                    if len(head) < 8:
                        break
                    ln, crc = struct.unpack("<II", head)
                    body = f.read(ln)
                    if len(body) < ln or \
                            _crc.crc32c(body, 0xFFFFFFFF) != crc:
                        break  # torn tail: stop replay (reference WAL)
                    good = f.tell()
                    for op in json.loads(body.decode()):
                        if op[0] == "set":
                            self._d[bytes.fromhex(op[1])] = \
                                bytes.fromhex(op[2])
                        else:
                            self._d.pop(bytes.fromhex(op[1]), None)
            if good < self.wal.stat().st_size:
                # truncate the torn bytes so post-restart appends are
                # not stranded behind a permanently unreadable record
                with open(self.wal, "r+b") as f:
                    f.truncate(good)
                    f.flush()
                    os.fsync(f.fileno())

    # -- API ----------------------------------------------------------------

    def get(self, key):
        with self._lock:
            return self._d.get(bytes(key))

    def submit(self, batch, sync=True):
        recs = []
        for op in batch.ops:
            if op[0] == "set":
                recs.append(["set", op[1].hex(), op[2].hex()])
            else:
                recs.append(["rm", op[1].hex()])
        body = json.dumps(recs).encode()
        head = struct.pack("<II", len(body),
                           _crc.crc32c(body, 0xFFFFFFFF))
        with self._lock:
            self._wal_f.write(head + body)
            self._wal_f.flush()
            if sync:
                os.fsync(self._wal_f.fileno())
            for op in batch.ops:
                if op[0] == "set":
                    self._d[op[1]] = op[2]
                else:
                    self._d.pop(op[1], None)
            self._since_compact += 1
            if self._since_compact >= self.compact_every:
                self._compact_locked()

    def _compact_locked(self) -> None:
        tmp = self.snap.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {k.hex(): v.hex() for k, v in self._d.items()}))
        os.replace(tmp, self.snap)
        self._wal_f.close()
        self._wal_f = open(self.wal, "wb")
        self._since_compact = 0

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    def iterate(self, prefix=b""):
        with self._lock:
            items = sorted((k, v) for k, v in self._d.items()
                           if k.startswith(prefix))
        yield from items

    def close(self) -> None:
        with self._lock:
            self._wal_f.close()


def open_kv(path: str | None, **kw) -> KeyValueDB:
    """Factory: no path = MemDB.  (Reference analog: KeyValueDB::create
    picking RocksDBStore, src/kv/KeyValueDB.cc.)  The reference's
    durable default, the LSM engine, is not ported yet, so a path
    raises."""
    if not path:
        return MemDB()
    from . import NOT_PORTED
    raise NotImplementedError(f"kv store at {path!r}: {NOT_PORTED}")

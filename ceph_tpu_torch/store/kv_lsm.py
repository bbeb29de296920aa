"""LsmDB — a leveled log-structured merge KeyValueDB.

Re-expresses the role of the reference's RocksDBStore (src/kv/
RocksDBStore.{h,cc}: the KV engine beneath BlueStore metadata, the mon
store, and PG-meta omap).  The previous LogDB rewrote a whole-DB JSON
snapshot every N commits — O(total keys) compaction, a scaling floor.
LsmDB has the real machinery, sized down to this build:

  memtable   dict + tombstones, byte-budgeted
  WAL        crc-framed append log (same torn-tail recovery discipline
             as LogDB / the reference WAL), one file per memtable
  SSTables   immutable sorted runs of 4 KiB crc'd blocks with a sparse
             (first-key-per-block) index in the footer — point reads
             touch one block, memory holds only the index
  manifest   the current version (files per level, next seq), replaced
             atomically; recovery = manifest + WAL replay
  compaction leveled: L0 accumulates whole memtables (overlapping);
             L0 full -> merge with overlapping L1 files; level over
             budget -> merge one file down.  I/O per compaction is
             bounded by the sizes of the participating files, never
             the whole DB.

Deliberate deviations from RocksDB: no bloom filters (point-miss cost
is one block read per touched level), no column families (the prefix
convention covers the callers), single-writer (callers serialize via
the store's op pipeline; the GIL would anyway).
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import struct
import threading
from pathlib import Path

from ..common import crc32c as _crc
from .kv import KeyValueDB, WriteBatch

_TOMBSTONE = 0xFFFFFFFF          # vlen sentinel for deletes inside SSTs
_SST_MAGIC = b"SST1"
_WAL_MAGIC = b"KVW1"


def _fsync_dir(path: Path) -> None:
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ----------------------------------------------------------------------------
# SSTable
# ----------------------------------------------------------------------------

class SSTWriter:
    """Streams sorted (key, value|None) records into crc'd blocks."""

    def __init__(self, path: Path, block_size: int = 4096):
        self.path = path
        self.block_size = block_size
        self.f = open(path, "wb")
        self.f.write(_SST_MAGIC)
        self.index: list[tuple[bytes, int]] = []  # (first_key, offset)
        self._block = bytearray()
        self._block_first: bytes | None = None
        self.count = 0
        self.min_key: bytes | None = None
        self.max_key: bytes | None = None

    def add(self, key: bytes, value: bytes | None) -> None:
        if self._block_first is None:
            self._block_first = key
        vlen = _TOMBSTONE if value is None else len(value)
        self._block += struct.pack("<HI", len(key), vlen) + key
        if value is not None:
            self._block += value
        self.count += 1
        if self.min_key is None:
            self.min_key = key
        self.max_key = key
        if len(self._block) >= self.block_size:
            self._flush_block()

    def _flush_block(self) -> None:
        if not self._block:
            return
        payload = bytes(self._block)
        self.index.append((self._block_first, self.f.tell()))
        self.f.write(struct.pack(
            "<II", len(payload), _crc.crc32c(payload, 0xFFFFFFFF)))
        self.f.write(payload)
        self._block = bytearray()
        self._block_first = None

    def finish(self) -> None:
        self._flush_block()
        idx_off = self.f.tell()
        idx = bytearray()
        for first, off in self.index:
            idx += struct.pack("<HQ", len(first), off) + first
        payload = bytes(idx)
        self.f.write(payload)
        self.f.write(struct.pack(
            "<QII", idx_off, len(payload),
            _crc.crc32c(payload, 0xFFFFFFFF)))
        self.f.write(_SST_MAGIC)
        self.f.flush()
        os.fsync(self.f.fileno())
        self.f.close()


class SSTReader:
    """Sparse-index reader; keeps the fd open so compaction can unlink
    the file under live iterators (POSIX keeps the inode alive).

    `pins` counts live LsmDB iterators holding this reader; `retired`
    marks it dropped by compaction.  A retired reader is closed by the
    DB as soon as its pin count reaches zero — deterministic fd
    release instead of relying on CPython refcounting GC."""

    def __init__(self, path: Path):
        self.path = path
        self.pins = 0
        self.retired = False
        self.f = open(path, "rb")
        self.f.seek(0, os.SEEK_END)
        end = self.f.tell()
        self.f.seek(end - 20)
        idx_off, idx_len, idx_crc = struct.unpack("<QII", self.f.read(16))
        if self.f.read(4) != _SST_MAGIC:
            raise ValueError(f"bad sst footer magic: {path}")
        self.f.seek(idx_off)
        payload = self.f.read(idx_len)
        if _crc.crc32c(payload, 0xFFFFFFFF) != idx_crc:
            raise ValueError(f"sst index crc mismatch: {path}")
        self.block_keys: list[bytes] = []
        self.block_offs: list[int] = []
        pos = 0
        while pos < len(payload):
            klen, off = struct.unpack_from("<HQ", payload, pos)
            pos += 10
            self.block_keys.append(payload[pos:pos + klen])
            pos += klen
            self.block_offs.append(off)
        self._end_of_blocks = idx_off

    def _read_block(self, bi: int) -> list[tuple[bytes, bytes | None]]:
        # pread: no shared seek state, so concurrent iterators on the
        # same reader can't corrupt each other's position
        off = self.block_offs[bi]
        head = os.pread(self.f.fileno(), 8, off)
        ln, crc = struct.unpack("<II", head)
        payload = os.pread(self.f.fileno(), ln, off + 8)
        if _crc.crc32c(payload, 0xFFFFFFFF) != crc:
            raise ValueError(
                f"sst block crc mismatch: {self.path} block {bi}")
        out = []
        pos = 0
        while pos < len(payload):
            klen, vlen = struct.unpack_from("<HI", payload, pos)
            pos += 6
            key = payload[pos:pos + klen]
            pos += klen
            if vlen == _TOMBSTONE:
                out.append((key, None))
            else:
                out.append((key, payload[pos:pos + vlen]))
                pos += vlen
        return out

    def get(self, key: bytes):
        """-> (found, value|None): distinguishes tombstone from miss."""
        bi = bisect.bisect_right(self.block_keys, key) - 1
        if bi < 0:
            return False, None
        for k, v in self._read_block(bi):
            if k == key:
                return True, v
        return False, None

    def scan(self, start: bytes = b""):
        """Yield (key, value|None) for keys >= start, in order."""
        bi = max(bisect.bisect_right(self.block_keys, start) - 1, 0)
        for b in range(bi, len(self.block_keys)):
            for k, v in self._read_block(b):
                if k >= start:
                    yield k, v

    def close(self) -> None:
        self.f.close()


class _RangeScan:
    """Iterator over a merged range scan holding SSTReader pins.

    A plain generator's `finally` can NOT carry the unpin: pins are
    taken eagerly (the snapshot — and the readers' liveness — is fixed
    at iterate_range() call time), but closing a never-started
    generator skips its try block entirely, so an iterator that is
    created and then abandoned would leak its pins forever.  This
    class releases exactly once on whichever comes first: exhaustion,
    explicit close(), or __del__ (refcount-prompt on CPython; on other
    runtimes LsmDB.close() still sweeps parked readers)."""

    def __init__(self, db, sources, end, pinned):
        self._db = db
        self._pinned = pinned
        self._gen = db._merge(sources, end)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._gen)
        except BaseException:
            self._release()
            raise

    def close(self) -> None:
        self._gen.close()
        self._release()

    def _release(self) -> None:
        pinned, self._pinned = self._pinned, None
        if pinned:
            self._db._unpin(pinned)

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self._release()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# ----------------------------------------------------------------------------
# LsmDB
# ----------------------------------------------------------------------------

class LsmDB(KeyValueDB):
    """Leveled LSM store behind the KeyValueDB interface."""

    def __init__(self, path: str, memtable_bytes: int = 4 << 20,
                 l0_max_files: int = 4, base_level_bytes: int = 32 << 20,
                 level_multiplier: int = 10, block_size: int = 4096,
                 target_file_bytes: int | None = None):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.memtable_bytes = memtable_bytes
        self.l0_max_files = l0_max_files
        self.base_level_bytes = base_level_bytes
        self.level_multiplier = level_multiplier
        self.block_size = block_size
        self.target_file_bytes = target_file_bytes or 2 * memtable_bytes
        self._lock = threading.RLock()
        self._mem: dict[bytes, bytes | None] = {}   # None = tombstone
        self._mem_bytes = 0
        # manifest state: levels[0] newest-last; levels[n>=1] sorted by
        # min key, non-overlapping
        self._levels: list[list[dict]] = [[]]
        self._readers: dict[str, SSTReader] = {}
        self._retired: list[SSTReader] = []   # dropped by compaction,
        # still pinned by live iterators; closed on last unpin/close
        self._next_seq = 1
        # observability: compaction I/O must stay bounded (the whole
        # point vs LogDB) — tests assert on these
        self.stats = {"flushes": 0, "compactions": 0,
                      "compact_bytes_in": 0, "compact_bytes_out": 0,
                      "max_compact_bytes": 0}
        self._load_manifest()
        # distinct WAL name: LogDB's wal.log shares the frame header but
        # carries JSON bodies — open_kv migrates those, and the name
        # split guarantees the two formats can never be cross-parsed
        self._wal_path = self.dir / "wal.lsm"
        self._replay_wal()
        self._wal_f = open(self._wal_path, "ab")

    # -- manifest / recovery ------------------------------------------------

    def _manifest_path(self) -> Path:
        return self.dir / "MANIFEST.json"

    def _load_manifest(self) -> None:
        mp = self._manifest_path()
        if not mp.exists():
            return
        m = json.loads(mp.read_text())
        self._next_seq = m["next_seq"]
        self._levels = []
        for files in m["levels"]:
            lvl = []
            for fe in files:
                p = self.dir / fe["name"]
                if not p.exists():      # crashed mid-compaction: the
                    continue            # manifest write is the commit
                # decoded bounds cached once (underscore keys stay out
                # of the manifest) — get() binary-searches these on
                # every read, and hex-decoding per lookup would sit on
                # the hottest metadata path
                fe["_min"] = bytes.fromhex(fe["min"])
                fe["_max"] = bytes.fromhex(fe["max"])
                lvl.append(fe)
                self._readers[fe["name"]] = SSTReader(p)
            self._levels.append(lvl)
        if not self._levels:
            self._levels = [[]]
        self._gc_unreferenced()

    def _write_manifest(self) -> None:
        m = {"next_seq": self._next_seq,
             "levels": [[{k: v for k, v in fe.items()
                          if not k.startswith("_")} for fe in lvl]
                        for lvl in self._levels]}
        tmp = self._manifest_path().with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(m, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())
        _fsync_dir(self.dir)

    def _gc_unreferenced(self) -> None:
        live = {fe["name"] for lvl in self._levels for fe in lvl}
        for p in self.dir.glob("*.sst"):
            if p.name not in live:
                p.unlink()

    def _replay_wal(self) -> None:
        if not self._wal_path.exists():
            return
        good = 0
        with open(self._wal_path, "rb") as f:
            while True:
                head = f.read(8)
                if len(head) < 8:
                    break
                ln, crc = struct.unpack("<II", head)
                body = f.read(ln)
                if len(body) < ln or \
                        _crc.crc32c(body, 0xFFFFFFFF) != crc:
                    break               # torn tail: stop replay
                good = f.tell()
                pos = 0
                while pos < len(body):
                    klen, vlen = struct.unpack_from("<HI", body, pos)
                    pos += 6
                    key = body[pos:pos + klen]
                    pos += klen
                    if vlen == _TOMBSTONE:
                        self._mem_insert(key, None)
                    else:
                        self._mem_insert(key, body[pos:pos + vlen])
                        pos += vlen
        if good < self._wal_path.stat().st_size:
            # drop the torn bytes BEFORE appending again: otherwise the
            # next restart's replay stops at the old tear and loses
            # fsync-acked batches written after it
            with open(self._wal_path, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())

    # -- memtable -----------------------------------------------------------

    def _mem_insert(self, key: bytes, value: bytes | None) -> None:
        old = self._mem.get(key)
        if key in self._mem:
            self._mem_bytes -= len(key) + (len(old) if old else 0)
        self._mem[key] = value
        self._mem_bytes += len(key) + (len(value) if value else 0)

    # -- public API ---------------------------------------------------------

    def get(self, key):
        key = bytes(key)
        with self._lock:
            if key in self._mem:
                return self._mem[key]
            for fe in reversed(self._levels[0]):     # newest L0 first
                found, v = self._readers[fe["name"]].get(key)
                if found:
                    return v
            for lvl in self._levels[1:]:
                fi = self._find_file(lvl, key)
                if fi is not None:
                    found, v = self._readers[lvl[fi]["name"]].get(key)
                    if found:
                        return v
            return None

    @staticmethod
    def _find_file(lvl: list[dict], key: bytes) -> int | None:
        """Binary search a non-overlapping level for the file covering
        key (cached decoded bounds — no per-read hex work)."""
        i = bisect.bisect_right(lvl, key, key=lambda fe: fe["_min"]) - 1
        if i >= 0 and key <= lvl[i]["_max"]:
            return i
        return None

    MAX_KEY = 0xFFFF     # keys pack as <H in the WAL/SST record format

    def submit(self, batch: WriteBatch, sync: bool = True) -> None:
        for op in batch.ops:
            if len(op[1]) > self.MAX_KEY:
                raise ValueError(
                    f"LsmDB key too long ({len(op[1])} > "
                    f"{self.MAX_KEY} bytes)")
        body = bytearray()
        for op in batch.ops:
            if op[0] == "set":
                body += struct.pack("<HI", len(op[1]), len(op[2]))
                body += op[1] + op[2]
            else:
                body += struct.pack("<HI", len(op[1]), _TOMBSTONE)
                body += op[1]
        payload = bytes(body)
        head = struct.pack("<II", len(payload),
                           _crc.crc32c(payload, 0xFFFFFFFF))
        with self._lock:
            self._wal_f.write(head + payload)
            self._wal_f.flush()
            if sync:
                os.fsync(self._wal_f.fileno())
            for op in batch.ops:
                self._mem_insert(op[1],
                                 op[2] if op[0] == "set" else None)
            if self._mem_bytes >= self.memtable_bytes:
                self._flush_locked()
                self._maybe_compact_locked()

    def compact(self) -> None:
        """Flush the memtable and fully settle level budgets."""
        with self._lock:
            if self._mem:
                self._flush_locked()
            self._maybe_compact_locked()

    @staticmethod
    def _prefix_end(prefix: bytes) -> bytes | None:
        """Smallest key > every key with this prefix (carry through
        trailing 0xff bytes); None = unbounded."""
        p = bytearray(prefix)
        while p and p[-1] == 0xFF:
            p.pop()
        if not p:
            return None
        p[-1] += 1
        return bytes(p)

    def iterate(self, prefix=b""):
        prefix = bytes(prefix)
        end = self._prefix_end(prefix) if prefix else None
        return self.iterate_range(prefix, end)

    def iterate_range(self, start: bytes = b"", end: bytes | None = None):
        """Merged range scan [start, end).  Consistent over the version
        at call time (the snapshot is taken HERE, not at first next()):
        every SSTReader the scan touches is pinned, so compaction can
        retire files underneath without disturbing the scan, and the
        retired reader's fd closes deterministically when the last
        pinning iterator finishes (generator exhaustion or .close())."""
        with self._lock:
            sources = []
            pinned: list[SSTReader] = []

            def _pin(name: str) -> SSTReader:
                r = self._readers[name]
                r.pins += 1
                pinned.append(r)
                return r

            # recency rank: memtable 0, L0 newest 1.., deeper levels last
            mem_items = sorted(
                (k, v) for k, v in self._mem.items() if k >= start)
            sources.append((0, iter(mem_items)))
            rank = 1
            for fe in reversed(self._levels[0]):
                sources.append((rank, _pin(fe["name"]).scan(start)))
                rank += 1
            for lvl in self._levels[1:]:
                its = [_pin(fe["name"]).scan(start)
                       for fe in lvl if fe["_max"] >= start]
                for it in its:
                    sources.append((rank, it))
                rank += 1

        return _RangeScan(self, sources, end, pinned)

    @staticmethod
    def _merge(sources, end):
        prev = None
        for k, v in LsmDB._merge_raw(sources):
            if end is not None and k >= end:
                return      # heap head is the global min: all done
            if k == prev:
                continue                 # older duplicate: shadowed
            prev = k
            if v is not None:
                yield k, v

    def close(self) -> None:
        with self._lock:
            self._wal_f.close()
            for r in self._readers.values():
                r.close()
            # compaction-retired readers kept alive for in-flight
            # iterators: close() is terminal, release them all
            for r in self._retired:
                r.close()
            self._retired.clear()

    def _unpin(self, readers: list[SSTReader]) -> None:
        """Iterator teardown: drop pins; close retired readers whose
        last pin just left (the deterministic half of the fd lifecycle
        — see SSTReader.pins)."""
        with self._lock:
            for r in readers:
                r.pins -= 1
                if r.retired and r.pins == 0:
                    r.close()
                    try:
                        self._retired.remove(r)
                    except ValueError:
                        pass

    # -- flush / compaction -------------------------------------------------

    def _new_sst(self, level: int,
                 items) -> list[dict]:
        """Write items (sorted (k, v|None)) into one or more SSTs split
        at target_file_bytes; returns file entries."""
        out = []
        w = None
        for k, v in items:
            if w is None:
                name = f"sst_{level}_{self._next_seq:08d}.sst"
                self._next_seq += 1
                w = SSTWriter(self.dir / name, self.block_size)
            w.add(k, v)
            if w.f.tell() >= self.target_file_bytes:
                w.finish()
                out.append(self._entry(w))
                w = None
        if w is not None:
            w.finish()
            if w.count:
                out.append(self._entry(w))
            else:
                (w.path).unlink()
        return out

    def _entry(self, w: SSTWriter) -> dict:
        self._readers[w.path.name] = SSTReader(w.path)
        size = w.path.stat().st_size
        self.stats["compact_bytes_out"] += size
        return {"name": w.path.name, "min": w.min_key.hex(),
                "max": w.max_key.hex(), "count": w.count, "bytes": size,
                "_min": w.min_key, "_max": w.max_key}

    def _flush_locked(self) -> None:
        items = sorted(self._mem.items())
        files = self._new_sst(0, items)
        self._levels[0].extend(files)
        self._write_manifest()           # commit point
        self._mem.clear()
        self._mem_bytes = 0
        self._wal_f.close()
        self._wal_f = open(self._wal_path, "wb")
        self._wal_f.flush()
        os.fsync(self._wal_f.fileno())
        self.stats["flushes"] += 1

    def _level_budget(self, level: int) -> int:
        return self.base_level_bytes * \
            self.level_multiplier ** (level - 1)

    def _maybe_compact_locked(self) -> None:
        while len(self._levels[0]) > self.l0_max_files:
            self._compact_level_locked(0, None)
        lvl = 1
        while lvl < len(self._levels):
            total = sum(fe["bytes"] for fe in self._levels[lvl])
            if total > self._level_budget(lvl):
                # push the file with the most overlap-free room —
                # oldest (lowest seq) keeps it deterministic
                victim = min(range(len(self._levels[lvl])),
                             key=lambda i: self._levels[lvl][i]["name"])
                self._compact_level_locked(lvl, victim)
            else:
                lvl += 1

    def _compact_level_locked(self, level: int,
                              victim: int | None) -> None:
        """Merge inputs from `level` (all of L0, or one victim file)
        with the overlapping files of level+1 into level+1."""
        if level == 0:
            up_files = list(self._levels[0])
        else:
            up_files = [self._levels[level][victim]]
        lo = min(fe["_min"] for fe in up_files)
        hi = max(fe["_max"] for fe in up_files)
        if len(self._levels) <= level + 1:
            self._levels.append([])
        down = self._levels[level + 1]
        overlap = [fe for fe in down
                   if not (fe["_max"] < lo or fe["_min"] > hi)]
        bottommost = (level + 2 >= len(self._levels) or
                      not any(self._levels[level + 2:]))
        # merge newest-first ranks: L0 newest-last in list
        sources = []
        rank = 0
        for fe in reversed(up_files):
            sources.append((rank, self._readers[fe["name"]].scan()))
            rank += 1
        for fe in overlap:
            sources.append((rank, self._readers[fe["name"]].scan()))
        rank += 1
        bytes_in = sum(fe["bytes"] for fe in up_files + overlap)

        def merged():
            for k, v in self._merge_raw(sources):
                if v is None and bottommost:
                    continue             # tombstone reaches bedrock
                yield k, v

        new_files = self._new_sst(level + 1, merged())
        # install: remove inputs, insert outputs sorted by min key
        if level == 0:
            self._levels[0] = []
        else:
            del self._levels[level][victim]
        keep = [fe for fe in down if fe not in overlap]
        self._levels[level + 1] = sorted(
            keep + new_files, key=lambda fe: fe["min"])
        self._write_manifest()           # commit point
        for fe in up_files + overlap:
            # retire the reader and unlink the file; the inode stays
            # alive behind the open fd, so in-flight scans finish
            # against the retired file.  Unpinned readers close NOW;
            # pinned ones park in _retired and close on last unpin (or
            # LsmDB.close()) — no fd accumulation on non-refcounting
            # runtimes across long compaction histories
            rd = self._readers.pop(fe["name"], None)
            (self.dir / fe["name"]).unlink(missing_ok=True)
            if rd is not None:
                rd.retired = True
                if rd.pins == 0:
                    rd.close()
                else:
                    self._retired.append(rd)
        self.stats["compactions"] += 1
        self.stats["compact_bytes_in"] += bytes_in
        self.stats["max_compact_bytes"] = max(
            self.stats["max_compact_bytes"], bytes_in)

    @staticmethod
    def _merge_raw(sources):
        """Merge (rank, iterator) sources keeping newest (lowest rank)
        per key; yields tombstones (v=None) too."""
        heap = []
        for rank, it in sources:
            for k, v in it:
                heap.append((k, rank, v, it))
                break
        heapq.heapify(heap)
        prev = None
        while heap:
            k, rank, v, it = heapq.heappop(heap)
            for nk, nv in it:
                heapq.heappush(heap, (nk, rank, nv, it))
                break
            if k == prev:
                continue
            prev = k
            yield k, v

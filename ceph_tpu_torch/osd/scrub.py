"""Scrub: background cross-shard consistency checking + repair.

Re-expresses the reference's scrub machinery (src/osd/PG.cc scrub
methods, PGBackend::be_scan_list PGBackend.cc:571, ScrubStore, and the
EC design note in doc/dev/osd_internals/erasure_coding/ecbackend.rst
"Scrub": EC shards self-check their local cumulative crc32c against the
stored hinfo, so a primary can detect bit rot without decoding):

  shallow scrub — every shard present, sizes consistent, hinfo attrs
                  agree across shards
  deep scrub    — additionally read each shard and verify its crc32c
                  against the hinfo entry
  repair        — reconstruct bad/missing shards from survivors via the
                  EC decode path and write them back

Deep scrub on the card: objects are walked in chunks; a chunk's shard
reads all fan out through `sub_read_batch` (one batched fan-out per
object instead of n sequential RPCs, every object's reads in flight
together), and every shard of the chunk is checksummed by ONE K5
launch (ops/crc32c_linear.crc32c_rows_device; the kernel is in
csrc/gf_encode_crc_acc.cu) instead of per-object host crc32c.  Full
2 KiB blocks go to the device and sub-block tails fold on the host; the
split is surfaced as the ec_scrub_device_bytes / ec_scrub_host_bytes
perf counters.  The device path is the default for a backend on the
card; a backend on the CPU takes the host crc32c (the native library)
unless the caller passes use_device=True, which runs K5's plain version.

Works against the ShardBackend seam, so the same code scrubs a local
MemStore PG (tests) and a messenger-backed PG (daemon asok command).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..common import crc32c as _crc
from .ec_backend import ECBackend
from .ec_transaction import shard_oid
from .ec_util import CHUNK_CRC_KEY, HINFO_KEY, HashInfo
from .types import hobject_t

# shard bytes per deep-scrub chunk (reads batched + one crc launch)
SCRUB_CHUNK_BYTES = 64 << 20


@dataclass
class ScrubError:
    oid: hobject_t
    shard: int
    kind: str          # missing | size_mismatch | crc_mismatch | hinfo
    detail: str = ""


@dataclass
class ScrubResult:
    objects: int = 0
    errors: list[ScrubError] = field(default_factory=list)
    repaired: list[ScrubError] = field(default_factory=list)
    device_bytes: int = 0
    host_bytes: int = 0

    @property
    def clean(self) -> bool:
        return not self.errors


@dataclass
class _ObjMeta:
    """Shallow-scrub view of one object + what deep verify needs."""
    oid: hobject_t
    sizes: dict[int, int | None]
    hinfos: dict[int, HashInfo | None]
    chunk_crcs: dict[int, int | None]
    present: list[int]
    majority: int = 0
    ref_hinfo: HashInfo | None = None
    errors: list[ScrubError] = field(default_factory=list)
    deep: bool = False          # deep verify applicable


def _use_device_default(backend: ECBackend) -> bool:
    """The K5 path for a backend on the card; the host crc32c for one
    on the CPU (where K5's plain version runs only when asked for)."""
    return backend.device.type == "cuda"


def _collect_meta(backend: ECBackend, oid: hobject_t,
                  deep: bool) -> _ObjMeta | None:
    """Shallow checks (presence / sizes / hinfo agreement) for one
    object; returns None for wholly-absent objects."""
    n = backend.n
    meta = _ObjMeta(oid, {}, {}, {}, [])
    for s in range(n):
        meta.sizes[s] = backend.shards.stat(s, oid)
        attrs = backend.shards.get_attrs(s, oid) or {}
        raw = attrs.get(HINFO_KEY)
        meta.hinfos[s] = HashInfo.decode(raw) if raw else None
        cc = attrs.get(CHUNK_CRC_KEY)
        meta.chunk_crcs[s] = int.from_bytes(cc, "little") if cc else None
    meta.present = [s for s in range(n) if meta.sizes[s] is not None]
    if not meta.present:
        return None
    if all(meta.sizes[s] == 0 for s in meta.present) and \
            all(meta.hinfos[s] is None for s in meta.present):
        # pure-metadata object (snapdir, SS-only head): no payload to
        # checksum, attrs are replicated by the write path
        return meta
    errors = meta.errors
    for s in range(n):
        if meta.sizes[s] is None:
            errors.append(ScrubError(oid, s, "missing"))
    # size consistency
    size_counts: dict[int, int] = {}
    for s in meta.present:
        size_counts[meta.sizes[s]] = size_counts.get(meta.sizes[s], 0) + 1
    meta.majority = max(size_counts, key=size_counts.get)
    for s in meta.present:
        if meta.sizes[s] != meta.majority:
            errors.append(ScrubError(
                oid, s, "size_mismatch",
                f"{meta.sizes[s]} != majority {meta.majority}"))
    # hinfo agreement (hinfo is replicated on every shard)
    for s in meta.present:
        if meta.hinfos[s] is not None:
            meta.ref_hinfo = meta.hinfos[s]
            break
    for s in meta.present:
        if meta.hinfos[s] is None:
            errors.append(ScrubError(oid, s, "hinfo", "missing hinfo"))
        elif meta.ref_hinfo is not None and meta.ref_hinfo.crc_valid and \
                meta.hinfos[s].cumulative_shard_hashes != \
                meta.ref_hinfo.cumulative_shard_hashes:
            errors.append(ScrubError(oid, s, "hinfo",
                                     "hinfo disagrees with peers"))
    meta.deep = bool(
        deep and meta.ref_hinfo is not None and
        meta.ref_hinfo.total_chunk_size == meta.majority)
    return meta


def _deep_read_chunk(backend: ECBackend, metas: list[_ObjMeta]
                     ) -> dict[tuple[hobject_t, int], np.ndarray]:
    """Fan out ALL shard reads of a scrub chunk through
    sub_read_batch (one batched fan-out per object, every object's
    fan-out issued before any wait) and gather the replies."""
    data: dict[tuple[hobject_t, int], np.ndarray] = {}
    lock = threading.Lock()
    ev = threading.Event()
    expect = sum(len(m.present) for m in metas if m.deep)
    got = {"n": 0}
    if not expect:
        return data

    def make_cb(oid):
        def on_done(shard, d):
            with lock:
                if d is not None:
                    data[(oid, shard)] = d
                got["n"] += 1
                fire = got["n"] >= expect
            if fire:
                ev.set()
        on_done.loop_safe = True      # store + Event.set only
        return on_done

    for m in metas:
        if not m.deep:
            continue
        backend.shards.sub_read_batch(
            [(s, m.oid, 0, m.majority) for s in m.present],
            make_cb(m.oid))
    # the old per-object path gave EACH object a 30 s read window; a
    # whole chunk's fan-out gets a deadline that scales with it
    ev.wait(timeout=max(30.0, 0.05 * expect))
    with lock:
        return dict(data)


def _verify_chunk(metas: list[_ObjMeta],
                  data: dict[tuple[hobject_t, int], np.ndarray],
                  use_device: bool, perf=None,
                  result: ScrubResult | None = None,
                  device="cuda") -> list[ScrubError]:
    """Deep verify of one chunk: ONE K5 launch on `device` checksums
    every shard of every object (variable lengths, see
    crc32c_linear.crc32c_rows_device), or the host crc32c when
    use_device is off."""
    errors: list[ScrubError] = []
    rows: list[np.ndarray] = []
    owners: list[tuple[_ObjMeta, int, int]] = []   # meta, shard, want
    for m in metas:
        if not m.deep:
            continue
        for s in m.present:
            d = data.get((m.oid, s))
            if d is None:
                # a present (stat'd) shard whose read never answered
                # must NOT silently count as verified — a timed-out
                # chunk read would otherwise report the PG clean
                errors.append(ScrubError(
                    m.oid, s, "read_error", "deep-read unanswered"))
                continue
            # integrity source: cumulative hinfo for append-only
            # objects; the shard's self-maintained chunk_crc once an
            # overwrite invalidated the hinfo (crc_valid also covers
            # legacy blobs persisted before the sticky flag existed)
            if not m.ref_hinfo.crc_valid:
                want = m.chunk_crcs[s]
                if want is None:
                    errors.append(ScrubError(
                        m.oid, s, "crc_source",
                        "overwritten object lacks chunk_crc"))
                    continue
            else:
                want = m.ref_hinfo.get_chunk_hash(s)
            rows.append(np.asarray(d, dtype=np.uint8))
            owners.append((m, s, want))
    if not rows:
        return errors
    nbytes = sum(r.size for r in rows)
    seeds = [0xFFFFFFFF] * len(rows)
    if use_device:
        import torch

        from ..common.util import next_pow2
        from ..ops import crc32c_linear as cl
        from ..ops.profiler import device_profiler
        # flight recorder: the deep-scrub CRC launch is a device
        # launch like any encode — ledgered with the reference's
        # bucket key (pow2 of rows and bytes)
        prof = device_profiler()
        rec = prof.begin("scrub_crc", codec="crc32c_rows",
                         runs=len(rows), nbytes=nbytes)
        got = cl.crc32c_rows_device(rows, seeds, device=device)
        # synchronous call: the submit clock (begin -> here) covers
        # staging, build + launch and the read-back; device_s stays 0
        # so the wall is counted ONCE (lat_launch_submit), not twice
        prof.submitted(rec, f"s:crc:n{next_pow2(len(rows))}"
                            f":w{next_pow2(nbytes)}", path="device",
                       jit=torch.device(device).type == "cuda")
        prof.materialized(rec, 0.0)
        # honest attribution: only full SCRUB_BLOCK bodies ride the
        # device launch; sub-block tails (and rows shorter than one
        # block) fold on host inside crc32c_rows_device
        dev_bytes = sum(r.size - r.size % cl.SCRUB_BLOCK for r in rows)
        host_bytes = nbytes - dev_bytes
        if perf:
            perf.inc("ec_scrub_device_bytes", dev_bytes)
            perf.inc("ec_scrub_host_bytes", host_bytes)
        if result is not None:
            result.device_bytes += dev_bytes
            result.host_bytes += host_bytes
    else:
        got = [_crc.crc32c(r.tobytes(), 0xFFFFFFFF) for r in rows]
        if perf:
            perf.inc("ec_scrub_host_bytes", nbytes)
        if result is not None:
            result.host_bytes += nbytes
    for (m, s, want), g in zip(owners, got):
        if g != want:
            errors.append(ScrubError(
                m.oid, s, "crc_mismatch", f"{g:#x} != {want:#x}"))
    return errors


def scrub_object(backend: ECBackend, oid: hobject_t,
                 deep: bool = True,
                 use_device: bool | None = None) -> list[ScrubError]:
    """Single-object scrub (repair re-checks and unit tests); the PG
    walk goes through scrub_pg's chunked/batched path."""
    if use_device is None:
        use_device = _use_device_default(backend)
    meta = _collect_meta(backend, oid, deep)
    if meta is None:
        return []
    errors = list(meta.errors)
    if meta.deep:
        data = _deep_read_chunk(backend, [meta])
        errors.extend(_verify_chunk([meta], data, use_device,
                                    perf=backend.perf,
                                    device=backend.device))
    return errors


def scrub_pg(backend: ECBackend, oids: list[hobject_t],
             deep: bool = True, repair: bool = False,
             chunk_bytes: int = SCRUB_CHUNK_BYTES,
             use_device: bool | None = None) -> ScrubResult:
    if use_device is None:
        use_device = _use_device_default(backend)
    result = ScrubResult()
    perf = backend.perf
    chunk: list[_ObjMeta] = []
    budget = 0

    def flush_chunk():
        nonlocal chunk, budget
        if not chunk:
            return
        data = _deep_read_chunk(backend, chunk) if deep else {}
        deep_errors = _verify_chunk(chunk, data, use_device,
                                    perf=perf, result=result,
                                    device=backend.device) \
            if deep else []
        by_oid: dict[hobject_t, list[ScrubError]] = {}
        for e in deep_errors:
            by_oid.setdefault(e.oid, []).append(e)
        for m in chunk:
            errors = m.errors + by_oid.get(m.oid, [])
            if errors and repair:
                bad_shards = sorted({e.shard for e in errors
                                     if e.kind in ("missing",
                                                   "crc_mismatch",
                                                   "size_mismatch")})
                if bad_shards and len(bad_shards) <= backend.m:
                    _repair_shards(backend, m.oid, bad_shards)
                    still = scrub_object(backend, m.oid, deep,
                                         use_device=use_device)
                    if not still:
                        result.repaired.extend(errors)
                        continue
                    errors = still
            result.errors.extend(errors)
        chunk = []
        budget = 0

    for oid in oids:
        result.objects += 1
        meta = _collect_meta(backend, oid, deep)
        if meta is None:
            continue
        chunk.append(meta)
        if meta.deep:
            budget += meta.majority * len(meta.present)
        if budget >= chunk_bytes:
            flush_chunk()
    flush_chunk()
    return result


def _repair_shards(backend: ECBackend, oid: hobject_t,
                   bad_shards: list[int]) -> None:
    """Rebuild bad shards from the good ones and write them back
    (reference repair path: recovery reconstruct + push).  The decode
    is the codec's (K1 on the card)."""
    from ..store.object_store import Transaction
    hinfo = backend._get_hinfo(oid)
    # read all good shards
    good = [s for s in range(backend.n) if s not in bad_shards]
    chunk_len = None
    for s in good:
        st = backend.shards.stat(s, oid)
        if st is not None:
            chunk_len = st
            break
    if chunk_len is None:
        return
    dense = np.zeros((backend.n, chunk_len), dtype=np.uint8)
    got: set[int] = set()
    counted = {"n": 0}
    ev = threading.Event()

    def on_done(shard, data):
        if data is not None:
            dense[shard] = data
            got.add(shard)
        counted["n"] += 1
        if counted["n"] >= len(good):
            ev.set()
    on_done.loop_safe = True

    backend.shards.sub_read_batch(
        [(s, oid, 0, chunk_len) for s in good], on_done)
    ev.wait(timeout=30)
    if len(got) < backend.k:
        return
    erasures = [s for s in range(backend.n) if s not in got]
    rebuilt = backend.ec_impl.decode_chunks(dense, erasures)
    from .ec_util import recovery_attrs
    for s in bad_shards:
        txn = Transaction()
        goid = shard_oid(oid, s)
        txn.remove(goid)
        txn.write(goid, 0, rebuilt[s])
        txn.setattrs(goid, recovery_attrs(hinfo, rebuilt[s]))
        backend.shards.sub_write(s, txn, lambda _s: None)

"""ECBackend: the erasure-coded write and read engine.

Re-expresses reference src/osd/ECBackend.{h,cc}, as ceph_tpu's
ECBackend does, with the codec launches on the card:

  submit_transaction (:1483) -> start_rmw (:1839, WritePlan)
  check_ops loop (:2151):
    try_state_to_reads  (:1865)  RMW pre-reads for partial stripes
    try_reads_to_commit (:1939)  encode + per-shard sub-writes
    try_finish_rmw      (:2103)  all shards committed -> client ack

When try_reads_to_commit drains, every op that is ready encodes in ONE
batched codec launch: appending extents go to the fused parity+crc32c
kernel (one launch for the drain), overwrite extents to the plain
parity kernel.

Dispatch-ahead: a drain is split into a submit half (assemble extents,
launch parity+crc, no host sync) and a completion half (wait for the
launch's event, fold crc seeds, issue sub-writes).  Up to
`dispatch_depth` drains stay in flight while more work is queued or a
`pipeline()` window is open, so assembly of drain N+1 overlaps device
compute of drain N; completion always runs in submit order, and a lone
op with nothing behind it completes synchronously.

Reads: the healthy path reassembles the k data shards; a degraded read
fans out to the parity shards and rebuilds the missing rows through
the plugin's decode (reconstruct-on-read).

Shard I/O goes through the ShardBackend seam; LocalShardBackend applies
to a local ObjectStore (the MemStore topology).

Not part of this module (yet): the multi-card mesh plane, the per-host
launch queue, the flight-recorder profiler and tracked ops, recovery,
backfill and CLAY repair.  Perf counters are optional (`perf=None`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..common import crc32c as _crc
from ..ec.interface import ErasureCodeError, ErasureCodeInterface
from ..store.object_store import ObjectStore, Transaction
from . import ec_transaction as ect
from . import ec_util
from .ec_transaction import Extent, PGTransaction, WritePlan, shard_oid
from .ec_util import HINFO_KEY, HashInfo, StripeInfo
from .extent_cache import ExtentCache
from .pg_log import LogEntry, LogOp, PGLog, RollbackInfo, ShardPGLog
from .types import eversion_t, hobject_t, spg_t


# -- shard seam --------------------------------------------------------------

class ShardBackend:
    """Transport seam to one PG's shard replicas (primary's view)."""

    def sub_write(self, shard: int, txn: Transaction,
                  on_commit: Callable[[int], None],
                  log_entries: list | None = None,
                  at_version=None, rollforward_to=None) -> None:
        """Apply txn on `shard`; log_entries (pg_log.LogEntry) persist
        atomically with it (reference ECSubWrite.log_entries)."""
        raise NotImplementedError

    def sub_read(self, shard: int, oid: hobject_t, off: int, length: int,
                 on_done: Callable[[int, np.ndarray | None], None]) -> None:
        """Read `length` bytes at chunk-offset `off` of oid's shard;
        on_done(shard, data|None-on-error)."""
        raise NotImplementedError

    def sub_read_batch(self, reqs, on_done) -> None:
        """Fan out [(shard, oid, off, length), ...]."""
        for shard, oid, off, length in reqs:
            self.sub_read(shard, oid, off, length, on_done)

    def get_hinfo(self, shard: int, oid: hobject_t) -> HashInfo | None:
        raise NotImplementedError

    def stat(self, shard: int, oid: hobject_t) -> int | None:
        raise NotImplementedError

    def probe(self, oid: hobject_t, n: int
              ) -> tuple["HashInfo | None", int | None]:
        """One metadata sweep: (hinfo, shard size).  hinfo is replicated
        on every shard; the first shard that has it answers."""
        hinfo = None
        size = None
        for s in range(n):
            if hinfo is None:
                hinfo = self.get_hinfo(s, oid)
                if hinfo is not None:
                    return hinfo, size
            if size is None:
                size = self.stat(s, oid)
        return hinfo, size


class LocalShardBackend(ShardBackend):
    """All shards in one local ObjectStore, per-shard collections (the
    local shard path of handle_sub_write, reference ECBackend.cc:2086)."""

    def __init__(self, store: ObjectStore, pgid, n_shards: int):
        self.store = store
        self.n_shards = n_shards
        self.cids = {s: spg_t(pgid, s) for s in range(n_shards)}
        for cid in self.cids.values():
            store.create_collection(cid)
        self.shard_logs = {s: ShardPGLog(store, self.cids[s], s)
                           for s in range(n_shards)}

    def sub_write(self, shard, txn, on_commit, log_entries=None,
                  at_version=None, rollforward_to=None):
        slog = self.shard_logs[shard]
        if log_entries and at_version is not None:
            slog.append_to_txn(txn, log_entries, at_version)
        self.store.queue_transactions(self.cids[shard], [txn])
        if log_entries:
            slog.record(log_entries, at_version)
            ec_util.refresh_chunk_crcs(self.store, self.cids[shard],
                                       shard, log_entries)
        if rollforward_to is not None:
            slog.advance_rollforward(rollforward_to)
        on_commit(shard)

    def sub_read(self, shard, oid, off, length, on_done):
        goid = shard_oid(oid, shard)
        try:
            data = self.store.read(self.cids[shard], goid, off, length)
        except KeyError:
            on_done(shard, None)
            return
        if data.size < length:  # pad short reads (sparse tail)
            data = np.concatenate(
                [data, np.zeros(length - data.size, dtype=np.uint8)])
        on_done(shard, data)

    def get_hinfo(self, shard, oid):
        goid = shard_oid(oid, shard)
        try:
            raw = self.store.getattr(self.cids[shard], goid, HINFO_KEY)
        except KeyError:
            return None
        return HashInfo.decode(raw)

    def stat(self, shard, oid):
        try:
            return self.store.stat(self.cids[shard], shard_oid(oid, shard))
        except KeyError:
            return None


# -- pipeline op -------------------------------------------------------------

@dataclass
class ECOp:
    """An in-flight client transaction (reference ECBackend::Op)."""
    txn: PGTransaction
    version: eversion_t
    on_commit: Callable[[], None]
    plan: WritePlan | None = None
    # metadata prefetched outside the pipeline lock (oid -> probe)
    meta: dict = field(default_factory=dict)
    pending_reads: int = 0
    read_data: dict[tuple[hobject_t, int], np.ndarray] = field(
        default_factory=dict)
    pending_commits: int = 0
    state: str = "queued"
    error: Exception | None = None
    # extents this op actually pinned in the ExtentCache: release must
    # mirror exactly the present() calls
    pinned: list[tuple[hobject_t, int, int]] = field(default_factory=list)


@dataclass
class _Drain:
    """One submitted (launched, not yet materialized) pipeline drain."""
    ops: list[ECOp]
    # (op, oid, extent, run (k, W)) per stripe-aligned extent, op order
    work: list[tuple]
    kinds: list[str]                  # per work item: "fused" | "plain"
    fused_handle: object | None       # plugin submit handle
    fused_pos: dict[int, int]         # work index -> position in handle
    plain_handle: object | None       # plugin encode_chunks_submit handle
    plain_cols: dict[int, int]        # work index -> column offset
    t_assemble: float = 0.0


class ECBackend:
    def __init__(self, ec_impl: ErasureCodeInterface, sinfo: StripeInfo,
                 shards: ShardBackend, log: PGLog | None = None,
                 dispatch_depth: int = 2, perf=None,
                 read_timeout: float = 30.0):
        self.ec_impl = ec_impl
        self.sinfo = sinfo
        self.shards = shards
        self.k = ec_impl.get_data_chunk_count()
        self.m = ec_impl.get_coding_chunk_count()
        self.n = ec_impl.get_chunk_count()
        assert sinfo.k == self.k
        self.read_timeout = max(0.05, float(read_timeout))
        self.log = log or PGLog()
        self.lock = threading.RLock()
        self.waiting_state: list[ECOp] = []
        self.waiting_reads: list[ECOp] = []
        self.waiting_commit: list[ECOp] = []
        self.completed: int = 0
        self.batched_launches: int = 0
        self.batched_extents: int = 0
        # kernel path of the last fused drain ("hier_acc" / "hier_lsub" /
        # "w32_flat", "+"-joined for a split drain; None before the first)
        self.fused_path: str | None = None
        self._hold = 0
        self.dispatch_depth = max(1, int(dispatch_depth))
        # optional counter set with inc/set/tinc (the daemon's perf
        # counters are not part of this slice)
        self.perf = perf
        self._inflight: "deque[_Drain]" = deque()
        self._pipeline_win = 0        # pipeline() windows currently open
        self._completing = False      # re-entrancy guard for completion
        # projected end-of-chunk per object across in-flight drains: the
        # submit-time append/fused decision for drain N+1 must see the
        # sizes drain N will produce
        self._sim_chunk: dict[hobject_t, int] = {}
        self._sim_refs: dict[hobject_t, int] = {}
        self.extent_cache = ExtentCache()
        # projected per-object state for queued-but-uncommitted ops
        # (reference HashInfo projected sizes, ECUtil.h:101-160)
        self._projected: dict[hobject_t, dict] = {}

    def _note_fused_path(self, path: str | None) -> None:
        """Record which kernel family served a drain: paths starting
        with "hier" (the hier kernels K2/K3, a split drain led by them)
        count as kernel drains, anything else (the flat entry) as a
        fallback, as ceph_tpu's ECBackend counts them."""
        self.fused_path = path
        if self.perf:
            self.perf.inc(
                "ec_fused_kernel_drains"
                if path and path.startswith("hier")
                else "ec_fused_fallback_drains")

    @contextmanager
    def batch(self):
        """Batch window: ops submitted inside encode in one codec launch
        (with synchronous stores this window provides the coalescing
        that async shard I/O provides in a cluster)."""
        with self.lock:
            self._hold += 1
        try:
            yield
        finally:
            with self.lock:
                self._hold -= 1
                if self._hold == 0:
                    self.check_ops()

    @contextmanager
    def pipeline(self):
        """Dispatch-ahead window: while open, up to `dispatch_depth`
        drains stay in flight on the device; everything completes, in
        submit order, when the window closes.  Ops drain immediately
        here; only materialization is deferred."""
        with self.lock:
            self._pipeline_win += 1
        try:
            yield
        finally:
            with self.lock:
                self._pipeline_win -= 1
                if self._pipeline_win == 0:
                    self.flush_pipeline()

    def flush_pipeline(self) -> None:
        """Complete every in-flight drain, in submit order."""
        with self.lock:
            if self._completing:
                return
            self._completing = True
            try:
                while self._inflight:
                    self._complete_drain(self._inflight.popleft())
            finally:
                self._completing = False
            if self.perf:
                self.perf.set("ec_inflight_depth", 0)

    # -- object metadata helpers -------------------------------------------

    def _get_size(self, oid: hobject_t) -> int:
        """True (unpadded) object size from the hinfo xattr; falls back
        to the stripe-derived size for objects without one."""
        hinfo, chunk = self.shards.probe(oid, self.n)
        if hinfo is not None:
            return hinfo.logical_size
        if chunk is not None:
            return self.sinfo.aligned_chunk_offset_to_logical_offset(chunk)
        return 0

    def exists(self, oid: hobject_t) -> bool:
        hinfo, chunk = self.shards.probe(oid, self.n)
        return hinfo is not None or chunk is not None

    # -- entry (reference submit_transaction :1483 / start_rmw :1839) ------

    def make_op(self, txn: PGTransaction,
                on_commit: Callable[[], None]) -> ECOp:
        """Stage an op without entering the pipeline: prefetches object
        metadata so no lock is held during the probe."""
        op = ECOp(txn, eversion_t(), on_commit)
        for oid in txn.ops:
            if oid not in self._projected:
                op.meta[oid] = self.shards.probe(oid, self.n)
        return op

    def enqueue(self, op: ECOp, version: eversion_t) -> ECOp:
        """Enter the pipeline; versions must enter the FIFO in order."""
        op.version = version
        with self.lock:
            self.waiting_state.append(op)
            self.check_ops()
        return op

    def submit_transaction(self, txn: PGTransaction, version: eversion_t,
                           on_commit: Callable[[], None]) -> ECOp:
        return self.enqueue(self.make_op(txn, on_commit), version)

    # -- pipeline (reference check_ops :2151) -------------------------------

    def check_ops(self) -> None:
        if self._hold:
            return
        self._try_state_to_reads()
        self._try_reads_to_commit()
        # (try_finish_rmw runs from the sub-write callbacks)

    def _try_state_to_reads(self) -> None:
        while self.waiting_state:
            op = self.waiting_state[0]
            cache: dict = {}

            def fetch(oid):
                """(hinfo|None, shard_size|None): projected (in-flight)
                state first, then the op's prefetched probe, then a
                probe under the lock."""
                proj = self._projected.get(oid)
                if proj is not None:
                    return proj["hinfo"], None
                if oid in op.meta:
                    return op.meta[oid]
                if oid not in cache:
                    cache[oid] = self.shards.probe(oid, self.n)
                return cache[oid]

            def get_hinfo(oid):
                h, _sz = fetch(oid)
                if h is None:
                    h = HashInfo.make(self.n)
                # later queued ops must chain off this same instance
                proj = self._projected.setdefault(
                    oid, {"hinfo": h, "refs": 0})
                proj["refs"] += 1
                return proj["hinfo"]

            def get_size(oid):
                h, chunk = fetch(oid)
                if h is not None:
                    return h.logical_size
                if chunk is not None:
                    return (self.sinfo
                            .aligned_chunk_offset_to_logical_offset(chunk))
                return 0

            def reset_hinfo(oid):
                """Delete-then-recreate: swap a fresh hinfo into the
                projected chain so this op and later queued ops seed
                from the recreate."""
                h = HashInfo.make(self.n)
                proj = self._projected.get(oid)
                if proj is not None:
                    proj["hinfo"] = h
                return h

            op.plan = ect.get_write_plan(
                self.sinfo, op.txn, get_hinfo, get_size,
                reset_hinfo=reset_hinfo)
            self.waiting_state.pop(0)
            op.state = "reading"
            self.waiting_reads.append(op)
            reads = [(oid, e) for oid, extents in op.plan.to_read.items()
                     for e in extents]
            op.pending_reads = len(reads)
            for oid, e in reads:
                self._start_rmw_read(op, oid, e)

    def _start_rmw_read(self, op: ECOp, oid: hobject_t, e: Extent) -> None:
        """Read one stripe-aligned logical extent back from the data
        shards (degraded shards reconstruct via decode)."""
        chunk_off = self.sinfo.aligned_logical_offset_to_chunk_offset(e.off)
        chunk_len = e.length // self.k
        got: dict[int, np.ndarray] = {}
        failed: set[int] = set()

        def on_done(shard: int, data: np.ndarray | None) -> None:
            if data is None:
                failed.add(shard)
            else:
                got[shard] = data
            if len(got) + len(failed) == self.k and not failed:
                logical = ec_util.decode(
                    self.sinfo, self.ec_impl, got, e.length)
                self._rmw_read_complete(op, oid, e, logical)
            elif failed and len(got) < self.k:
                self._read_with_reconstruct(op, oid, e, chunk_off,
                                            chunk_len, got, failed)

        for s in range(self.k):
            self.shards.sub_read(s, oid, chunk_off, chunk_len, on_done)

    def _read_with_reconstruct(self, op, oid, e, chunk_off, chunk_len,
                               got, failed) -> None:
        """Degraded pre-read: pull parity shards until k available
        (reference objects_read_and_reconstruct :2345)."""
        tried = set(got) | set(failed)
        candidates = [s for s in range(self.n) if s not in tried]

        def on_done(shard, data):
            if data is not None:
                got[shard] = data
            if len(got) >= self.k:
                logical = ec_util.decode(
                    self.sinfo, self.ec_impl,
                    dict(list(got.items())[: self.k] if len(got) > self.k
                         else got), e.length)
                self._rmw_read_complete(op, oid, e, logical)

        if len(candidates) + len(got) < self.k:
            raise ErasureCodeError(5, f"unrecoverable: {oid} extent {e}")
        for s in candidates[: self.k - len(got)]:
            self.shards.sub_read(s, oid, chunk_off, chunk_len, on_done)

    def _rmw_read_complete(self, op, oid, e, logical) -> None:
        with self.lock:
            op.read_data[(oid, e.off)] = logical
            op.pending_reads -= 1
            if op.pending_reads == 0:
                self._try_reads_to_commit()

    # -- encode + commit (reference try_reads_to_commit :1939) --------------

    def _assemble_extent(self, op: ECOp, oid: hobject_t,
                         e: Extent) -> np.ndarray:
        """Overlay new writes on pre-read/zero background for one
        stripe-aligned extent."""
        buf = np.zeros(e.length, dtype=np.uint8)
        rd = op.read_data.get((oid, e.off))
        if rd is not None:
            buf[: rd.size] = rd
        else:
            for (roid, roff), data in op.read_data.items():
                if roid != oid:
                    continue
                lo = max(e.off, roff)
                hi = min(e.end, roff + data.size)
                if lo < hi:
                    buf[lo - e.off:hi - e.off] = data[lo - roff:hi - roff]
        # bytes assembled by earlier in-flight ops win over store reads
        self.extent_cache.overlay(oid, e.off, buf)
        for w in op.txn.ops[oid].writes:
            lo = max(e.off, w.offset)
            hi = min(e.end, w.end)
            if lo < hi:
                buf[lo - e.off:hi - e.off] = w.data[lo - w.offset:hi - w.offset]
        return buf

    def _try_reads_to_commit(self) -> None:
        ready: list[ECOp] = []
        while self.waiting_reads and self.waiting_reads[0].pending_reads == 0:
            ready.append(self.waiting_reads.pop(0))
        if ready:
            try:
                drain = self._submit_drain(ready)
            except Exception as e:  # noqa: BLE001 — encode staging died
                # complete earlier in-flight drains FIRST so their acks
                # precede these ops' error acks
                self.flush_pipeline()
                for op in ready:
                    self._abort_op(op, e)
            else:
                self._inflight.append(drain)
                if self.perf:
                    self.perf.inc("ec_drain_submits")
                    self.perf.set("ec_inflight_depth", len(self._inflight))
        self._drain_pipeline()

    # -- submit half: assemble + launch, NO host sync -----------------------

    def _submit_drain(self, ready: list[ECOp]) -> _Drain:
        """Gather every extent of every ready op, encode the whole drain
        with launches that do not wait for the card (one fused launch
        for appends + one plain launch for overwrites), and record the
        in-flight drain."""
        t0 = time.perf_counter()
        k = self.k
        work: list[tuple] = []
        runs: list[np.ndarray] = []
        for op in ready:
            op.state = "encoding"
            for oid, extents in op.plan.will_write.items():
                for e in extents:
                    buf = self._assemble_extent(op, oid, e)
                    # pin so later ops see these bytes, not stale reads
                    self.extent_cache.present(oid, e.off, buf)
                    op.pinned.append((oid, e.off, e.length))
                    nstripes = e.length // self.sinfo.stripe_width
                    work.append((op, oid, e, buf))
                    runs.append(buf.reshape(
                        nstripes, k, self.sinfo.chunk_size)
                        .transpose(1, 0, 2).reshape(k, -1))
        drain = _Drain(ops=ready, work=work, kinds=[],
                       fused_handle=None, fused_pos={},
                       plain_handle=None, plain_cols={})
        if not work:
            return drain
        # every chunk-aligned appending extent of the whole drain gets
        # parity + cumulative shard crcs from one fused launch; the
        # append decision uses _sim_chunk, the projected end-of-chunk
        # across all in-flight drains.  Overwrites take the plain path.
        fused_idx: list[int] = []
        plain_idx: list[int] = []
        deleted: set[tuple[int, hobject_t]] = set()
        for i, ((op, oid, e, _), run) in enumerate(zip(work, runs)):
            hinfo = op.plan.hash_infos[oid]
            if op.txn.ops[oid].delete and (id(op), oid) not in deleted:
                # delete-then-recreate: the fresh plan hinfo starts at 0
                deleted.add((id(op), oid))
                self._sim_chunk[oid] = 0
            cur = self._sim_chunk.get(oid, hinfo.total_chunk_size)
            chunk_off = self.sinfo.aligned_logical_offset_to_chunk_offset(
                e.off)
            if chunk_off == cur:
                fused_idx.append(i)
                self._sim_chunk[oid] = cur + run.shape[1]
            else:
                plain_idx.append(i)
                self._sim_chunk[oid] = max(cur, chunk_off + run.shape[1])
            self._sim_refs[oid] = self._sim_refs.get(oid, 0) + 1
        # txn-level size effects after the writes: truncate clamps the
        # projection (only for objects this drain tracks)
        for op in ready:
            for oid, objop in op.txn.ops.items():
                if objop.truncate_to is not None and \
                        oid in self._sim_refs:
                    self._sim_chunk[oid] = \
                        self.sinfo.logical_to_next_chunk_offset(
                            objop.truncate_to)
        fused_set = set(fused_idx)
        drain.kinds = ["fused" if i in fused_set else "plain"
                       for i in range(len(work))]
        try:
            if fused_idx:
                drain.fused_pos = {wi: p for p, wi in enumerate(fused_idx)}
                drain.fused_handle = \
                    self.ec_impl.encode_extents_with_crc_submit(
                        [runs[i] for i in fused_idx])
                self._note_fused_path(drain.fused_handle["path"])
            if plain_idx:
                col = 0
                for i in plain_idx:
                    drain.plain_cols[i] = col
                    col += runs[i].shape[1]
                plain_runs = [runs[i] for i in plain_idx]
                big = np.concatenate(plain_runs, axis=1) \
                    if len(plain_runs) > 1 else plain_runs[0]
                drain.plain_handle = self.ec_impl.encode_chunks_submit(big)
        except Exception:
            # undo this drain's projection refs before the caller aborts
            # the ops (a stale projection would push every later append
            # of these objects off the fused path)
            for _, oid, _, _ in work:
                self._sim_refs[oid] -= 1
                if self._sim_refs[oid] <= 0:
                    del self._sim_refs[oid]
                    self._sim_chunk.pop(oid, None)
            raise
        drain.work = [(op, oid, e, run)
                      for (op, oid, e, _), run in zip(work, runs)]
        self.batched_launches += 1 + (1 if fused_idx and plain_idx else 0)
        self.batched_extents += len(work)
        drain.t_assemble = time.perf_counter() - t0
        if self.perf:
            self.perf.inc("ec_drain_extents", len(work))
            self.perf.tinc("ec_drain_assemble", drain.t_assemble)
        return drain

    def _drain_pipeline(self) -> None:
        """Completion policy: keep up to dispatch_depth drains in flight
        while more work is imminent (a pipeline window is open, or ops
        are queued behind us); otherwise flush — a lone op with nothing
        behind it completes synchronously."""
        if self._completing:
            return
        self._completing = True
        try:
            while self._inflight:
                more = (self._pipeline_win > 0
                        or bool(self.waiting_state)
                        or bool(self.waiting_reads
                                and self.waiting_reads[0]
                                .pending_reads == 0))
                allowed = self.dispatch_depth if more else 0
                if len(self._inflight) <= allowed:
                    break
                self._complete_drain(self._inflight.popleft())
        finally:
            self._completing = False
        if self.perf:
            self.perf.set("ec_inflight_depth", len(self._inflight))

    # -- completion half: materialize + fold + sub-writes -------------------

    def _drop_sim_refs(self, drain: _Drain) -> None:
        """Drop this drain's projection refs; the last in-flight drain
        touching an object releases its _sim_chunk entry."""
        for _, oid, _, _ in drain.work:
            self._sim_refs[oid] -= 1
            if self._sim_refs[oid] <= 0:
                del self._sim_refs[oid]
                self._sim_chunk.pop(oid, None)

    def _complete_drain(self, drain: _Drain) -> None:
        t0 = time.perf_counter()
        try:
            try:
                fh = drain.fused_handle
                fused_res = [] if fh is None else \
                    self.ec_impl.encode_extents_with_crc_finalize(fh)
                ph = drain.plain_handle
                plain_par = None if ph is None else \
                    self.ec_impl.encode_chunks_finalize(ph)
            except Exception as e:  # noqa: BLE001 — device/encode failure
                if self.perf:
                    self.perf.inc("ec_drain_errors")
                for op in drain.ops:
                    self._abort_op(op, e)
                return
            device_dt = time.perf_counter() - t0
            encoded_by_op: dict[int, dict] = {id(op): {}
                                              for op in drain.ops}
            crcs_by_op: dict[int, dict] = {id(op): {} for op in drain.ops}
            fused_ls: dict[int, tuple] = {}
            for i, (op, oid, e, run) in enumerate(drain.work):
                if drain.kinds[i] == "fused":
                    par, l, tail, body = fused_res[drain.fused_pos[i]]
                    fused_ls[i] = (l, tail, body)
                else:
                    col = drain.plain_cols[i]
                    par = plain_par[:, col:col + run.shape[1]]
                encoded_by_op[id(op)][(oid, e.off)] = \
                    np.concatenate([run, par], axis=0)
            self._fold_drain_crcs(drain, encoded_by_op, fused_ls,
                                  crcs_by_op)
            t1 = time.perf_counter()
            for op in drain.ops:
                try:
                    self._commit_op(op, encoded_by_op[id(op)],
                                    crcs_by_op[id(op)])
                except Exception as e:  # noqa: BLE001
                    if self.perf:
                        self.perf.inc("ec_drain_errors")
                    self._abort_op(op, e)
            if self.perf:
                self.perf.tinc("ec_drain_device", device_dt)
                self.perf.tinc("ec_drain_commit", time.perf_counter() - t1)
        finally:
            self._drop_sim_refs(drain)

    def _fold_drain_crcs(self, drain: _Drain, encoded_by_op: dict,
                         fused_ls: dict, crcs_by_op: dict) -> None:
        """One ordered host pass over the drain computing cumulative
        shard crcs for every appending extent: fused extents fold the
        device-combined L (O(1) combines per shard), plain extents fold
        all k+m shard rows with one vectorised crc32c_rows call.  Seeds
        chain per object exactly as generate_transactions will apply
        them; a mismatch yields no precomputed crc and generate falls
        back to its own host append."""
        sim_size: dict[hobject_t, int] = {}
        sim_hash: dict[hobject_t, list[int]] = {}
        items_by_op: dict[int, list[int]] = {}
        for i, (op, _, _, _) in enumerate(drain.work):
            items_by_op.setdefault(id(op), []).append(i)
        for op in drain.ops:
            for oid, objop in op.txn.ops.items():
                if objop.delete:
                    sim_size[oid] = 0
                    sim_hash.pop(oid, None)
            for i in items_by_op.get(id(op), []):
                _, oid, e, run = drain.work[i]
                hinfo = op.plan.hash_infos[oid]
                chunk_off = (self.sinfo
                             .aligned_logical_offset_to_chunk_offset(e.off))
                cur = sim_size.get(oid, hinfo.total_chunk_size)
                width = run.shape[1]
                if chunk_off != cur:
                    sim_size[oid] = max(cur, chunk_off + width)
                    sim_hash.pop(oid, None)
                    continue
                seeds = sim_hash.get(
                    oid, list(hinfo.cumulative_shard_hashes))
                if i in fused_ls:
                    l, tail, body = fused_ls[i]
                    crcs = self.ec_impl.fold_extent_crcs(
                        l, tail, seeds, body)
                else:
                    crcs = _crc.crc32c_rows(
                        encoded_by_op[id(op)][(oid, e.off)], seeds)
                sim_hash[oid] = crcs
                sim_size[oid] = cur + width
                crcs_by_op[id(op)][(oid, e.off)] = crcs
            for oid, objop in op.txn.ops.items():
                if objop.truncate_to is not None:
                    sim_size[oid] = \
                        self.sinfo.logical_to_next_chunk_offset(
                            objop.truncate_to)
                    sim_hash.pop(oid, None)

    def _abort_op(self, op: ECOp, err: Exception) -> None:
        """An op that dies before/at commit goes through the in-order
        finish queue with its error attached, so the pipeline never
        wedges and acks never reorder."""
        op.error = err
        op.state = "failed"
        op.pending_commits = 0
        if op not in self.waiting_commit:
            self.waiting_commit.append(op)
        self._try_finish_rmw()

    def _commit_op(self, op: ECOp, encoded: dict,
                   crcs: dict | None = None) -> None:
        # PG log entries with rollback info (reference log_operation
        # :958), snapshotted before generate_transactions mutates hinfo
        entries: list[LogEntry] = []
        gen_oids: set[hobject_t] = set()
        for oid, objop in op.txn.ops.items():
            rb = RollbackInfo()
            old_size = op.plan.sizes.get(oid, 0)
            hinfo = op.plan.hash_infos.get(oid)
            existed = old_size > 0 or (
                hinfo is not None and hinfo.total_chunk_size > 0)
            if not objop.delete:
                rb.append_old_size = old_size
                aligned_old = self.sinfo.logical_to_next_stripe_offset(
                    old_size)
                rb.old_chunk_size = (
                    self.sinfo.aligned_logical_offset_to_chunk_offset(
                        aligned_old))
                rb.pure_append = (
                    bool(op.plan.will_write.get(oid))
                    and all(e.off >= aligned_old
                            for e in op.plan.will_write.get(oid, []))
                    and (objop.truncate_to is None or not existed)
                    and not objop.attrs)
                rb.hinfo_old = hinfo.encode() if existed else None
            # anything not a pure append keeps the old object under a
            # generation so the shard can roll it back locally
            if objop.delete or (existed and not rb.pure_append):
                rb.kept_generation = op.version.version
                gen_oids.add(oid)
            self.log.add(LogEntry(
                op.version, oid,
                LogOp.DELETE if objop.delete else LogOp.MODIFY, rb))
            entries.append(self.log.entries[-1])
        txns, _ = ect.generate_transactions(
            self.sinfo, self.n, op.plan, op.txn, encoded, crcs,
            gen=op.version.version, gen_oids=gen_oids)
        op.state = "committing"
        op.pending_commits = self.n
        self.waiting_commit.append(op)

        def on_commit(shard: int) -> None:
            with self.lock:
                op.pending_commits -= 1
                if op.pending_commits == 0:
                    self._try_finish_rmw()

        rf = self.log.rollforward_to
        for s in range(self.n):
            try:
                self.shards.sub_write(s, txns[s], on_commit,
                                      log_entries=entries,
                                      at_version=op.version,
                                      rollforward_to=rf)
            except Exception as e:  # noqa: BLE001 — a failed sub-write
                # must not wedge the in-order commit queue: count the
                # shard as resolved (failed) and carry the error to the ack
                op.error = op.error or e
                if self.perf:
                    self.perf.inc("ec_drain_errors")
                on_commit(s)

    def _try_finish_rmw(self) -> None:
        """reference try_finish_rmw :2103: in-order completion, advance
        rollforward bounds, ack clients."""
        while self.waiting_commit and \
                self.waiting_commit[0].pending_commits == 0:
            op = self.waiting_commit.pop(0)
            op.state = "failed" if op.error is not None else "done"
            self.log.roll_forward_to(op.version)
            for oid, off, length in op.pinned:
                self.extent_cache.release(oid, off, length)
            op.pinned.clear()
            for oid in op.txn.ops:
                proj = self._projected.get(oid)
                if proj is not None:
                    proj["refs"] -= 1
                    if proj["refs"] <= 0:
                        del self._projected[oid]
            self.completed += 1
            op.on_commit()
        self.check_ops()

    # -- client reads (reference objects_read_and_reconstruct :2345) --------

    def read(self, oid: hobject_t, off: int = 0,
             length: int | None = None) -> np.ndarray:
        """Client read.  Healthy path: the k data shards answer and the
        logical bytes reassemble without a decode.  Degraded path
        (reconstruct-on-read): any data-shard failure fans out to the
        parity shards and the missing rows rebuild through the plugin's
        decode.  The fan-out wait is `read_timeout`."""
        size = self._get_size(oid)
        if length is None:
            length = size - off
        if length <= 0 or off >= size:
            return np.empty(0, dtype=np.uint8)
        start, span = self.sinfo.offset_len_to_stripe_bounds(off, length)
        chunk_off = self.sinfo.aligned_logical_offset_to_chunk_offset(start)
        chunk_len = span // self.k
        glock = threading.Lock()
        got: dict[int, np.ndarray] = {}
        failed: set[int] = set()
        ready = threading.Event()
        issued = [0]

        def on_done(shard, data):
            with glock:       # replies may race on reader threads
                if data is None:
                    failed.add(shard)
                else:
                    got[shard] = data
                if len(got) >= self.k or \
                        len(got) + len(failed) >= issued[0]:
                    ready.set()

        issued[0] = self.k
        self.shards.sub_read_batch(
            [(s, oid, chunk_off, chunk_len) for s in range(self.k)],
            on_done)
        timeout = self.read_timeout
        with glock:
            need_parity = bool(failed) and len(got) < self.k
        if not need_parity:
            if not ready.wait(timeout=timeout) and self.perf:
                self.perf.inc("ec_read_timeouts")
            with glock:
                need_parity = len(got) < self.k
        if need_parity:
            # degraded: fan out to parity shards until k gathered
            # (reference get_remaining_shards :1633)
            with glock:
                ready.clear()
                issued[0] = self.n
                if len(got) >= self.k or \
                        len(got) + len(failed) >= self.n:
                    ready.set()
            self.shards.sub_read_batch(
                [(s, oid, chunk_off, chunk_len)
                 for s in range(self.k, self.n)], on_done)
            if not ready.wait(timeout=timeout) and self.perf:
                self.perf.inc("ec_read_timeouts")
        with glock:
            have = dict(got)
        if len(have) < self.k:
            raise ErasureCodeError(5, f"unrecoverable read {oid}")
        if set(range(self.k)) <= set(have):
            use = {s: have[s] for s in range(self.k)}
            logical = ec_util.decode(self.sinfo, self.ec_impl, use, span)
        else:
            logical = self._reconstruct_read(have, chunk_len, span)
        return logical[off - start:off - start + length]

    def _reconstruct_read(self, have: dict[int, np.ndarray],
                          chunk_len: int, span: int) -> np.ndarray:
        """Reconstruct-on-read: rebuild the missing data shards of a
        degraded read with the plugin's decode."""
        if self.perf:
            self.perf.inc("ec_reconstruct_reads")
            self.perf.inc("ec_reconstruct_read_bytes", span)
        use = dict(list(sorted(have.items()))[: self.k])
        if self.ec_impl.get_sub_chunk_count() != 1:
            return ec_util.decode(self.sinfo, self.ec_impl, use, span)
        erasures = [s for s in range(self.n) if s not in use]
        dense = np.zeros((self.n, chunk_len), dtype=np.uint8)
        for s, d in use.items():
            dense[s] = d
        dec = np.asarray(self.ec_impl.decode_chunks(dense, erasures))
        nstripes = chunk_len // self.sinfo.chunk_size
        logical = dec[: self.k] \
            .reshape(self.k, nstripes, self.sinfo.chunk_size) \
            .transpose(1, 0, 2).reshape(-1)
        return logical[:span]

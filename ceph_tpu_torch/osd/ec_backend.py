"""ECBackend: the erasure-coded write, read and recovery engine.

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

Per-host launch queue (`launch_queue=`, parallel/launch_queue.py):
when one is wired, a drain submits its fused runs and its plain run to
the shared queue, which coalesces them with other PGs' into one launch
a window; completion and in-order acks stay per PG.  Without one, the
drain launches through the plugin directly.  Plugins without the
submit halves (the host plugins jerasure, isa, lrc, shec, clay) encode
synchronously on the host, their appends' crcs folded on the host.

Reads: the healthy path reassembles the k data shards; a degraded read
fans out to the parity shards and rebuilds the missing rows through the
decode path: the launch queue (co-batched with other PGs' repair
decodes) or the plugin's decode (reconstruct-on-read).

Recovery (reference continue_recovery_op :570), batched: an OSD-loss
storm queues many objects missing the same shards, so
`recover_shards_batch` fans out every object's survivor reads first,
groups them by (survivors, targets) geometry and rebuilds each group in
as few decode launches as DECODE_MAX_LAUNCH_W allows.  A single lost
chunk of a CLAY pool reads only the repair planes of d helpers (1/q of
each helper chunk) and rebuilds through the pool's ClayRepairPlan
(K4): through the queue when one is wired, else one `apply_batch` a
(lost, helpers) group.  A helper read failure falls back to the
full-read decode for that object (`ec_clay_repair_fallbacks`).  A loss
that a device plugin's minimum set repairs from fewer than k helpers
(the layered LRC's local group) reads only those helpers and decodes
on the full-read path's groups (`ec_local_repairs`; a failed helper
read re-reads every source shard, `ec_local_repair_fallbacks`).

The mesh plane (`mesh_codec=` or `mesh_service=`,
parallel/mesh.DistributedStripeCodec): when a mesh codec serves the
backend, a drain's runs are plain-encoded on the mesh (fusion is off,
`can_fuse` false) and their crc32c folded on the host, and reconstruct
reads, batched recovery decodes and CLAY repairs go through the mesh's
decode_flat, decode_flat_batch and clay_repair_batch.  A geometry,
matrix or no-matrix mismatch sets `mesh_error` and the backend serves
from the single-card plane; a failed mesh launch aborts that op (a
drain) or falls through to the single-card plane (a read or a
recovery), and `_disable_mesh` moves every later op there, counted in
`ec_mesh_errors` and the MeshService ledger.  The single-card plane is
the same kernels on the codec's own device.

Shard I/O goes through the ShardBackend seam; LocalShardBackend applies
to a local ObjectStore (the MemStore topology), and the OSD daemon's
MessengerShardBackend (osd/daemon.py) sends each shard's sub-write and
sub-read across the messenger to the acting set.

The daemon is this module's caller in a cluster: its primary PGs
submit client writes with their tracked op (`top=`,
common/tracked_op.py), so every op's timeline records its encode
launch, the flight recorder's launch ids that served it (and a first
build that stalled), its materialize, and each shard's sub-write sent
and acked; the ops' trace ids ride the launch records.  With
`ec_dispatch_ahead` the daemon holds the dispatch-ahead window open
for good (`set_pipelined`): a flush timer completes the last drains
when the op stream goes idle, and `inflight_ops` lists the ops on the
card for `dump_ops_in_flight`.  The daemon also runs recovery under the
mClock recovery class and its repair throttle, and deep scrub through
osd/scrub.py.  The counters default to `_build_ec_perf`'s set; any
object with inc, set and tinc may stand in (`perf=`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..common import crc32c as _crc
from ..common.tracked_op import NULL_TRACKED
from ..common.util import concat_columns, split_columns
from ..ec.interface import ErasureCodeError, ErasureCodeInterface
from ..ops.profiler import device_profiler
from ..parallel.launch_queue import (DECODE_MAX_LAUNCH_W, _codec_label,
                                     _extents_bucket)
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
                  at_version=None, rollforward_to=None,
                  trace: dict | None = None, top=None) -> None:
        """Apply txn on `shard`; log_entries (pg_log.LogEntry) persist
        atomically with it (reference ECSubWrite.log_entries).  trace
        is an optional child TraceContext wire dict: remote transports
        forward it so the shard holder's sub-op span stitches under the
        primary's op span."""
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

    def get_attrs(self, shard: int, oid: hobject_t) -> dict | None:
        """All xattrs of the shard object (hinfo + chunk_crc + user);
        None when the shard object is absent."""
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
                  at_version=None, rollforward_to=None, trace=None,
                  top=None):
        # trace, top: wire-plane trace stitching; local shards have no
        # wire, so they are accepted and unused here
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

    def get_attrs(self, shard, oid):
        try:
            return self.store.getattrs(self.cids[shard],
                                       shard_oid(oid, shard))
        except KeyError:
            return None

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
    # per-op trace/timeline (common/tracked_op.py); NULL_TRACKED when
    # tracking is off, and every mark_event below is then a no-op
    top: object = NULL_TRACKED


@dataclass
class _Drain:
    """One submitted (launched, not yet materialized) pipeline drain."""
    ops: list[ECOp]
    # (op, oid, extent, run (k, W)) per stripe-aligned extent, op order
    work: list[tuple]
    kinds: list[str]                  # per work item: "fused" | "plain"
    fused_handle: object | None       # plugin submit handle | ticket
    fused_pos: dict[int, int]         # work index -> position in handle
    plain_handle: tuple | None        # ("queue"|"mesh"|"plugin"|"np", h)
    plain_cols: dict[int, int]        # work index -> column offset
    t_assemble: float = 0.0
    # flight-recorder records of direct (non-queue) launches; queue
    # launches are recorded by the queue itself
    prof_fused: object | None = None
    prof_plain: object | None = None


@dataclass
class _Recovery:
    """One submitted recovery slice: per group, its objects' states and
    the wait that returns their rebuilt shards."""
    push_for: Callable
    results: dict = field(default_factory=dict)
    clay: list = field(default_factory=list)     # [(sts, wait)]
    decode: list = field(default_factory=list)   # [(sts, wait)]


def _build_ec_perf(name: str):
    """The backend's own counter set (reference _build_ec_perf)."""
    from ..common.perf_counters import PerfCountersBuilder
    return (PerfCountersBuilder(name)
            .add_u64_counter("ec_drain_submits", "pipeline drains launched")
            .add_u64_counter("ec_drain_extents", "extents encoded")
            .add_u64_counter("ec_drain_errors",
                             "sub-write/encode failures absorbed")
            .add_gauge("ec_inflight_depth",
                       "drains in flight after last submit")
            .add_time_avg("ec_drain_assemble",
                          "host assemble+launch time per drain")
            .add_time_avg("ec_drain_device",
                          "device materialize (block) time per drain")
            .add_time_avg("ec_drain_commit",
                          "sub-write issue time per drain")
            .add_u64_counter("ec_fused_kernel_drains",
                             "fused drains served by the hier kernels")
            .add_u64_counter("ec_fused_fallback_drains",
                             "fused drains served by the flat or byte "
                             "entry")
            .add_u64_counter("ec_host_queue_drains",
                             "drains routed through the per-host "
                             "launch queue (cross-PG batching)")
            .add_u64_counter("ec_scrub_device_bytes",
                             "deep-scrub bytes crc'd on device")
            .add_u64_counter("ec_scrub_host_bytes",
                             "deep-scrub bytes crc'd on host")
            .add_u64_counter("ec_mesh_drains",
                             "drains dispatched to the mesh plane")
            .add_u64_counter("ec_mesh_repair_launches",
                             "batched distributed repair decodes")
            .add_u64_counter("ec_mesh_errors",
                             "mesh launch failures (plane fell back)")
            .add_u64_counter("ec_repair_helper_bytes",
                             "survivor/helper bytes read for repair")
            .add_u64_counter("ec_repair_reconstructed_bytes",
                             "shard bytes rebuilt by repair decodes")
            .add_u64_counter("ec_clay_repairs",
                             "objects repaired from repair-plane reads "
                             "(bandwidth-optimal CLAY path)")
            .add_u64_counter("ec_clay_repair_launches",
                             "batched CLAY repair-plan launches")
            .add_u64_counter("ec_clay_repair_fallbacks",
                             "CLAY plane-read repairs that fell back "
                             "to the full-read decode path")
            .add_u64_counter("ec_local_repairs",
                             "objects rebuilt from fewer than k helpers "
                             "(the plugin's minimum set, LRC's local "
                             "group)")
            .add_u64_counter("ec_local_repair_fallbacks",
                             "local repairs whose helper read failed "
                             "and fell back to the full-read decode "
                             "path")
            .add_u64_counter("ec_reconstruct_reads",
                             "degraded client reads served by "
                             "reconstruct-on-read")
            .add_u64_counter("ec_reconstruct_read_bytes",
                             "logical bytes served by "
                             "reconstruct-on-read")
            .add_u64_counter("ec_read_timeouts",
                             "client-read shard fan-outs that hit "
                             "read_timeout")
            .create_perf_counters())


class ECBackend:
    def __init__(self, ec_impl: ErasureCodeInterface, sinfo: StripeInfo,
                 shards: ShardBackend, log: PGLog | None = None,
                 launch_queue=None, dispatch_depth: int = 2, perf=None,
                 perf_name: str = "ec", read_timeout: float = 30.0,
                 clay_repair: bool = True,
                 device: str | torch.device | None = None,
                 mesh_codec=None, mesh_service=None, logger=None):
        self.ec_impl = ec_impl
        self.sinfo = sinfo
        self.shards = shards
        self.k = ec_impl.get_data_chunk_count()
        self.m = ec_impl.get_coding_chunk_count()
        self.n = ec_impl.get_chunk_count()
        assert sinfo.k == self.k
        # where this backend's own device work runs (the CLAY repair
        # plans): the codec's device, else the card unless the caller
        # passes "cpu"; a CUDA request without a GPU raises
        codec_dev = getattr(ec_impl, "device", None)
        self.device = resolve_device(
            device if device is not None else codec_dev or "cuda")
        if codec_dev is not None and \
                torch.device(codec_dev) != self.device:
            raise ValueError(f"codec on {codec_dev}, backend asked for "
                             f"{self.device}")
        self._logger = logger
        # the multi-card data plane (parallel/mesh.DistributedStripeCodec):
        # acquired from the per-host MeshService when one is supplied; a
        # directly injected codec (tests, benches) takes precedence.
        # Geometry/matrix mismatches are config errors, not crashes: the
        # backend logs, records mesh_error and serves from the
        # single-card plane
        self.mesh_error: str | None = None
        self._mesh_service = mesh_service
        self._mesh_fallen = None
        if mesh_codec is None and mesh_service is not None:
            impl_matrix = getattr(ec_impl, "matrix", None)
            if impl_matrix is None:
                # no generator matrix to validate against (bitmatrix-only
                # or layered codes): an unvalidated mesh codec could
                # silently write divergent parity — refuse it
                self._mesh_config_error(
                    "plugin exposes no generator matrix to validate "
                    "against the mesh codec")
            else:
                try:
                    mesh_codec = mesh_service.acquire(
                        self.k, self.m,
                        technique=getattr(ec_impl, "technique", "cauchy"),
                        matrix=impl_matrix)
                except Exception as e:  # noqa: BLE001 — MeshError et al
                    self._mesh_config_error(f"mesh acquire failed: {e}")
                    mesh_codec = None
        if mesh_codec is not None:
            why = self._mesh_geometry_error(mesh_codec)
            if why is not None:
                self._mesh_config_error(why)
                mesh_codec = None
        self.mesh_codec = mesh_codec
        # per-host EC launch queue (parallel/launch_queue.py): when set,
        # drains, repair decodes and CLAY repairs submit there and
        # coalesce with other PGs'; completion and in-order acks stay
        # per PG
        self._launch_queue = launch_queue
        self.read_timeout = max(0.05, float(read_timeout))
        # CLAY plane-read repair: single-shard recovery of a sub-chunked
        # plugin with a repair lowering reads only the repair planes of
        # d helpers; off = always full-read decode
        self._clay_repair = bool(clay_repair)
        self._clay_plans: dict[tuple, object] = {}
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
        self.perf = perf if perf is not None else _build_ec_perf(perf_name)
        self._inflight: "deque[_Drain]" = deque()
        self._pipeline_win = 0        # pipeline() windows currently open
        self._completing = False      # re-entrancy guard for completion
        # persistent dispatch-ahead (set_pipelined): the flush timer
        self._auto_flush_ms: float | None = None
        self._flush_timer = None
        # projected end-of-chunk per object across in-flight drains: the
        # submit-time append/fused decision for drain N+1 must see the
        # sizes drain N will produce
        self._sim_chunk: dict[hobject_t, int] = {}
        self._sim_refs: dict[hobject_t, int] = {}
        self.extent_cache = ExtentCache()
        # projected per-object state for queued-but-uncommitted ops
        # (reference HashInfo projected sizes, ECUtil.h:101-160)
        self._projected: dict[hobject_t, dict] = {}

    # -- mesh plane management ----------------------------------------------

    def _log(self, msg: str) -> None:
        if self._logger is not None:
            self._logger(msg)
        else:
            from ..common.dout import dout
            dout("ec", 1, msg)

    def _mesh_geometry_error(self, mesh_codec) -> str | None:
        """Why `mesh_codec` cannot serve this backend (None = it can)."""
        if (mesh_codec.k, mesh_codec.m) != (self.k, self.m):
            return (f"mesh codec geometry k={mesh_codec.k} "
                    f"m={mesh_codec.m} does not match the EC profile "
                    f"k={self.k} m={self.m}")
        # the technique must match too: cauchy parity written by the
        # mesh is garbage to a reed_sol_van plugin's decode matrix
        impl_matrix = getattr(self.ec_impl, "matrix", None)
        if impl_matrix is not None and \
                not np.array_equal(mesh_codec.matrix, impl_matrix):
            return ("mesh codec generator matrix does not match the "
                    "plugin's — mesh parity would not decode on the "
                    "single-chip plane")
        return None

    def _mesh_config_error(self, why: str) -> None:
        self.mesh_error = why
        self._log(f"EC mesh plane unavailable ({why}); "
                  f"serving from the single-chip codec")

    def _disable_mesh(self, err: BaseException) -> None:
        """Containment: a failed mesh launch aborts its op (the caller
        does that); here the backend moves every later op to the
        single-card plane, so nothing is dispatched to the broken mesh
        again.  Reported to the MeshService ledger."""
        if self.mesh_codec is None:
            return
        # drains already in flight on the mesh keep their codec: their
        # results may still materialize
        self._mesh_fallen = self.mesh_codec
        self.mesh_codec = None
        self.mesh_error = f"mesh plane disabled after failure: {err!r}"
        self._log(self.mesh_error)
        if self.perf:
            self.perf.inc("ec_mesh_errors")
        if self._mesh_service is not None:
            self._mesh_service.note_failure(err)

    def mesh_status(self) -> dict:
        """Per-backend plane state (the OSD's `mesh status`)."""
        mc = self.mesh_codec
        return {
            "active": mc is not None,
            "mesh": ({"shard": mc.n_shard, "data": mc.n_data}
                     if mc is not None else None),
            "error": self.mesh_error,
        }

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

    def repair_status(self) -> dict:
        """Per-PG repair state: the helper-bytes-read vs
        reconstructed-bytes ledger (the CLAY savings made visible) plus
        reconstruct-on-read and read-timeout provenance."""
        dump = self.perf.dump() if hasattr(self.perf, "dump") else {}

        def u64(key):
            v = dump.get(key, 0)
            return int(v) if isinstance(v, (int, float)) else 0
        helper = u64("ec_repair_helper_bytes")
        rebuilt = u64("ec_repair_reconstructed_bytes")
        return {
            "helper_bytes_read": helper,
            "reconstructed_bytes": rebuilt,
            "helper_bytes_per_rebuilt": round(helper / rebuilt, 3)
            if rebuilt else None,
            "clay_repairs": u64("ec_clay_repairs"),
            "clay_repair_launches": u64("ec_clay_repair_launches"),
            "clay_repair_fallbacks": u64("ec_clay_repair_fallbacks"),
            "clay_plans_cached": len(self._clay_plans),
            "local_repairs": u64("ec_local_repairs"),
            "local_repair_fallbacks": u64("ec_local_repair_fallbacks"),
            "mesh_repair_launches": u64("ec_mesh_repair_launches"),
            "reconstruct_reads": u64("ec_reconstruct_reads"),
            "reconstruct_read_bytes": u64("ec_reconstruct_read_bytes"),
            "read_timeouts": u64("ec_read_timeouts"),
            "read_timeout_s": self.read_timeout,
            "clay_plane_repair": self._clay_repair,
        }

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

    def set_pipelined(self, flush_ms: float = 2.0) -> None:
        """Persistent dispatch-ahead (daemon mode): the window never
        closes, so a flush timer bounds the commit latency of the last
        drains when the op stream goes idle."""
        with self.lock:
            self._pipeline_win += 1
            self._auto_flush_ms = max(0.1, float(flush_ms))

    def _arm_auto_flush(self) -> None:
        if self._auto_flush_ms is None or self._flush_timer is not None:
            return

        def _fire():
            with self.lock:
                self._flush_timer = None
            # the timer's own thread: select the backend's card first
            with (torch.cuda.device(self.device)
                  if self.device.type == "cuda" else nullcontext()):
                self.flush_pipeline()

        t = threading.Timer(self._auto_flush_ms / 1000.0, _fire)
        t.daemon = True
        self._flush_timer = t
        t.start()

    def inflight_ops(self) -> list[ECOp]:
        """Ops submitted to the device pipeline, not yet committing
        (for dump_ops_in_flight)."""
        with self.lock:
            return [op for d in self._inflight for op in d.ops]

    # -- object metadata helpers -------------------------------------------

    def _fetch_hinfo(self, oid: hobject_t) -> HashInfo | None:
        """hinfo is replicated on every shard; one probe sweep (local
        shard first, rest in parallel — see ShardBackend.probe)."""
        return self.shards.probe(oid, self.n)[0]

    def _get_hinfo(self, oid: hobject_t) -> HashInfo:
        return self._fetch_hinfo(oid) or HashInfo.make(self.n)

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
                on_commit: Callable[[], None], top=None) -> ECOp:
        """Stage an op without entering the pipeline: prefetches object
        metadata so no lock is held during the probe.  top: the op's
        tracked timeline (common/tracked_op.py), NULL_TRACKED if None."""
        op = ECOp(txn, eversion_t(), on_commit,
                  top=top if top is not None else NULL_TRACKED)
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
                           on_commit: Callable[[], None],
                           top=None) -> ECOp:
        return self.enqueue(self.make_op(txn, on_commit, top=top),
                            version)

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
        # every pre-read that overlaps the extent: a write spanning
        # stripes pre-reads its head and its tail stripe apart (ceph_tpu
        # takes only the read keyed at the extent's start when there is
        # one, and so drops the tail stripe's bytes after the write)
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
                self._arm_auto_flush()
        self._drain_pipeline()

    # -- submit half: assemble + launch, NO host sync -----------------------

    def _submit_drain(self, ready: list[ECOp]) -> _Drain:
        """Gather every extent of every ready op, encode the whole drain
        with launches that do not wait for the card (one fused launch
        for appends + one plain launch for overwrites, or submissions
        to the launch queue), and record the in-flight drain."""
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
        # across all in-flight drains.  Overwrites take the plain path,
        # and so does every run while a mesh codec serves the backend:
        # the mesh plain-encodes and the crcs fold on the host
        fused_idx: list[int] = []
        plain_idx: list[int] = []
        can_fuse = self.mesh_codec is None and \
            hasattr(self.ec_impl, "encode_extents_with_crc_submit")
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
            if can_fuse and chunk_off == cur:
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
        prof = device_profiler()
        codec = _codec_label(self.ec_impl)
        queue = self._launch_queue
        # direct launches record the ops' trace ids here; queue
        # submissions carry them to the queue's super-batch record
        traces = tuple(op.top.trace.trace_id for op in ready
                       if op.top.is_tracked) if prof.enabled else ()
        try:
            if fused_idx:
                drain.fused_pos = {wi: p for p, wi in enumerate(fused_idx)}
                fused_runs = [runs[i] for i in fused_idx]
                if queue is not None:
                    # the queue coalesces these runs with other PGs';
                    # the kernel path is known at completion
                    drain.fused_handle = queue.submit_extents(
                        self.ec_impl, fused_runs, owner=id(self),
                        traces=traces)
                    if self.perf:
                        self.perf.inc("ec_host_queue_drains")
                else:
                    rec = prof.begin(
                        "fused_encode", codec=codec, runs=len(fused_runs),
                        nbytes=sum(r.size for r in fused_runs),
                        traces=traces)
                    drain.fused_handle = \
                        self.ec_impl.encode_extents_with_crc_submit(
                            fused_runs)
                    prof.submitted(rec, _extents_bucket(drain.fused_handle),
                                   path=drain.fused_handle["path"])
                    drain.prof_fused = rec
                    self._note_fused_path(drain.fused_handle["path"])
            if plain_idx:
                col = 0
                for i in plain_idx:
                    drain.plain_cols[i] = col
                    col += runs[i].shape[1]
                plain_runs = [runs[i] for i in plain_idx]
                big = np.concatenate(plain_runs, axis=1) \
                    if len(plain_runs) > 1 else plain_runs[0]
                # a sub-chunked code (CLAY) lays its planes over the
                # whole run it encodes, so runs concatenated would encode
                # as one chunk: each run encodes alone, on the host
                # (ceph_tpu's ECBackend concatenates them, and recovery
                # of such an object then fails its crc check)
                sub_chunked = self.ec_impl.get_sub_chunk_count() != 1
                if self.mesh_codec is not None and not sub_chunked:
                    rec = prof.begin("mesh_encode", codec=codec,
                                     nbytes=int(big.size), traces=traces)
                    try:
                        drain.plain_handle = (
                            "mesh", self.mesh_codec.encode_flat_submit(big))
                    except Exception as e:  # noqa: BLE001 — mesh died
                        # containment: this drain's ops abort (the
                        # caller), later drains take the single-card
                        # plane
                        self._disable_mesh(e)
                        raise
                    prof.submitted(rec, f"mesh:x:w{big.shape[1]}",
                                   path="mesh")
                    drain.prof_plain = rec
                    if self.perf:
                        self.perf.inc("ec_mesh_drains")
                elif queue is not None and not sub_chunked:
                    drain.plain_handle = ("queue", queue.submit_chunks(
                        self.ec_impl, big, owner=id(self), traces=traces))
                    if self.perf and not fused_idx:
                        self.perf.inc("ec_host_queue_drains")
                elif hasattr(self.ec_impl, "encode_chunks_submit"):
                    rec = prof.begin("plain_encode", codec=codec,
                                     nbytes=int(big.size), traces=traces)
                    h = self.ec_impl.encode_chunks_submit(big)
                    drain.plain_handle = ("plugin", h)
                    prof.submitted(rec, f"c:{h[0]}:w{big.shape[1]}",
                                   path=str(h[0]))
                    drain.prof_plain = rec
                else:
                    # host-synchronous plugins: the whole encode is the
                    # submit; nothing runs on a device
                    rec = prof.begin("plain_encode", codec=codec,
                                     nbytes=int(big.size), traces=traces)
                    drain.plain_handle = ("np", np.concatenate(
                        [np.asarray(self.ec_impl.encode_chunks(r))
                         for r in (plain_runs if sub_chunked else [big])],
                        axis=1))
                    prof.submitted(rec, f"c:np:w{big.shape[1]}", path="np",
                                   jit=False)
                    prof.materialized(rec, 0.0)
        except Exception:
            # withdraw a queue submission this drain already made: the
            # owning ops are about to abort, and an orphaned pending
            # submission would launch work nobody finalizes
            if getattr(drain.fused_handle, "is_launch_ticket", False):
                drain.fused_handle.cancel()
            # undo this drain's projection refs before the caller aborts
            # the ops (a stale projection would push every later append
            # of these objects off the fused path)
            for _, oid, _, _ in work:
                self._sim_refs[oid] -= 1
                if self._sim_refs[oid] <= 0:
                    del self._sim_refs[oid]
                    self._sim_chunk.pop(oid, None)
            raise
        # submit half done: the device work is in flight and no host
        # sync has happened; only ops that contributed encode extents
        # get the event
        worked = {id(op) for op, _, _, _ in work}
        for op in ready:
            if id(op) in worked:
                op.top.mark_event("ec_encode_launch")
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

    def _stitch_launches(self, drain: _Drain, prof) -> None:
        """Trace stitching (ops/profiler.py): the launch ids that served
        this drain land as events on every contributing op's timeline,
        and a first build that stalled past the threshold lands first,
        so slow-op blame (largest gap ends at the event) names the
        bucket that built instead of a bare "ec_encode_materialize"."""
        worked = {id(op) for op, _, _, _ in drain.work}
        stitches = []
        for src in (drain.fused_handle, drain.plain_handle[1]
                    if drain.plain_handle is not None else None):
            if getattr(src, "is_launch_ticket", False) and \
                    src.launch_id is not None:
                stitches.append((src.launch_id, src.bucket, src.compiled,
                                 src.compile_s, src.cache_hit))
        for rec in (drain.prof_fused, drain.prof_plain):
            if rec is not None:
                stitches.append((rec.launch_id, rec.bucket, rec.compiled,
                                 rec.compile_s, rec.cache_hit))
        stall_s = prof.stall_s
        for op in drain.ops:
            if id(op) in worked:
                for lid, bucket, compiled, comp_s, c_hit in stitches:
                    # a cached library load is a fast first launch, not
                    # a stall: it never takes the build blame
                    if compiled and not c_hit and comp_s >= stall_s:
                        op.top.mark_event(f"first_compile({bucket})")
                    op.top.mark_event(f"launch({lid})")
                op.top.mark_event("ec_encode_materialize")

    def _complete_drain(self, drain: _Drain) -> None:
        t0 = time.perf_counter()
        prof = device_profiler()
        try:
            try:
                fh = drain.fused_handle
                if fh is None:
                    fused_res = []
                elif getattr(fh, "is_launch_ticket", False):
                    # result() forces the shared launch if the window
                    # has not fired and demuxes this submission's runs
                    fused_res = fh.result()
                    self._note_fused_path(fh.path)
                else:
                    fused_res = \
                        self.ec_impl.encode_extents_with_crc_finalize(fh)
                    prof.materialized(drain.prof_fused,
                                      time.perf_counter() - t0)
                plain_par = None
                if drain.plain_handle is not None:
                    kind, h = drain.plain_handle
                    t_p = time.perf_counter()
                    if kind == "queue":
                        plain_par = np.asarray(h.result())
                    elif kind == "mesh":
                        # _mesh_fallen: the plane was disabled after this
                        # drain launched; its own launch may still
                        # materialize (and aborts cleanly if not)
                        mc = self.mesh_codec or self._mesh_fallen
                        plain_par = mc.encode_flat_finalize(h)
                        prof.materialized(drain.prof_plain,
                                          time.perf_counter() - t_p)
                    elif kind == "plugin":
                        plain_par = self.ec_impl.encode_chunks_finalize(h)
                        prof.materialized(drain.prof_plain,
                                          time.perf_counter() - t_p)
                    else:
                        plain_par = h
            except Exception as e:  # noqa: BLE001 — device/encode failure
                if self.perf:
                    self.perf.inc("ec_drain_errors")
                # the fused and plain halves are separate queue tickets:
                # when one raises, withdraw the other if it is still
                # pending, or the window worker launches it for nobody
                for h in (drain.fused_handle,
                          drain.plain_handle[1]
                          if drain.plain_handle is not None else None):
                    if getattr(h, "is_launch_ticket", False):
                        h.cancel()
                if drain.plain_handle is not None and \
                        drain.plain_handle[0] == "mesh":
                    # a mesh finalize failure aborts this drain's ops and
                    # moves later drains to the single-card plane
                    self._disable_mesh(e)
                for op in drain.ops:
                    self._abort_op(op, e)
                return
            device_dt = time.perf_counter() - t0
            self._stitch_launches(drain, prof)
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
        top = op.top
        tracked = top.is_tracked
        # one child span for the whole shard fan-out (the holder's
        # sub-op description carries the shard); per-shard spans would
        # cost n uuid draws per op on the hot path
        wire_trace = top.trace.child().to_wire() if tracked else None
        if tracked:
            top.mark_event("sub_write_sent")

        def on_commit(shard: int) -> None:
            if tracked:
                top.mark_event(f"sub_write_ack({shard})")
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
                                      rollforward_to=rf,
                                      trace=wire_trace,
                                      top=top if tracked else None)
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
            op.top.mark_event("failed" if op.error is not None
                              else "commit")
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
        degraded read through the decode path — the mesh's decode_flat
        when that plane is up, else the per-host launch queue
        (co-batched with other PGs' repair decodes) when one is wired,
        the plugin's decode otherwise.  Sub-chunked codes (CLAY) keep
        the dict-decode path: a partial chunk run does not respect their
        plane layout."""
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
        dec = None
        if self.mesh_codec is not None:
            survivors = tuple(sorted(use))
            targets = tuple(s for s in range(self.k) if s not in use)
            try:
                rows = self.mesh_codec.decode_flat(
                    dense[list(survivors)], survivors, targets)
            except Exception as e:  # noqa: BLE001 — mesh died mid-read
                self._disable_mesh(e)
            else:
                dec = dense
                for i, t in enumerate(targets):
                    dec[t] = rows[i]
        if dec is None and self._launch_queue is not None:
            dec = np.asarray(self._launch_queue.submit_decode(
                self.ec_impl, dense, erasures, owner=id(self)).result())
        elif dec is None:
            dec = np.asarray(self.ec_impl.decode_chunks(dense, erasures))
        nstripes = chunk_len // self.sinfo.chunk_size
        logical = dec[: self.k] \
            .reshape(self.k, nstripes, self.sinfo.chunk_size) \
            .transpose(1, 0, 2).reshape(-1)
        return logical[:span]

    # -- recovery (reference continue_recovery_op :570) ---------------------
    #
    # Batched: an OSD-loss storm queues many objects missing the same
    # shards, so the batch entry fans out every object's survivor reads
    # concurrently, groups the results by (survivors, targets) recovery
    # geometry, and rebuilds each group in as few decode launches as the
    # width cap allows (through the launch queue when one is wired).

    def recover_shard(self, oid: hobject_t, missing: list[int],
                      push: Callable[[int, np.ndarray, HashInfo], None]
                      ) -> None:
        """Rebuild `missing` shards of oid from any k survivors and hand
        each to `push(shard, data, hinfo)` (the caller writes it to the
        new home)."""
        res = self.recover_shards_batch([(oid, list(missing))],
                                        lambda _oid: push)
        err = res.get(oid)
        if err is not None:
            raise err

    def _start_recovery_reads(self, oid: hobject_t, missing: list[int],
                              sources=None) -> dict:
        """Phase 1 of a batched recovery: metadata probe + survivor read
        fan-out for ONE object (every shard not missing, or the fewer
        `sources` of a local repair), returning the gathering state
        WITHOUT waiting — a storm issues all its reads before the first
        wait."""
        hinfo = self._get_hinfo(oid)
        chunk_len = None
        for s in range(self.n):
            if s in missing:
                continue
            chunk_len = self.shards.stat(s, oid)
            if chunk_len is not None:
                break
        if chunk_len is None:
            raise ErasureCodeError(5, f"cannot recover {oid}: no survivor")
        got: dict[int, np.ndarray] = {}
        glock = threading.Lock()
        done = {"n": 0}
        ready = threading.Event()
        local = sources is not None
        if not local:
            sources = [s for s in range(self.n) if s not in missing]
        need = min(self.k, len(sources))

        def on_done(sh, d):
            with glock:       # replies race on reader threads
                if d is not None:
                    got[sh] = d
                done["n"] += 1
                fire = len(got) >= need or done["n"] >= len(sources)
            if fire:
                ready.set()

        self.shards.sub_read_batch(
            [(s, oid, 0, chunk_len) for s in sources], on_done)
        return {"oid": oid, "missing": list(missing), "hinfo": hinfo,
                "chunk_len": chunk_len, "got": got, "glock": glock,
                "ready": ready, "sources": tuple(sources), "local": local}

    def _verify_recovered(self, st: dict, s: int,
                          data: np.ndarray) -> None:
        """Verify a rebuilt shard against the stored hinfo (reference
        handle_sub_read crc check, ECBackend.cc:991)."""
        hinfo = st["hinfo"]
        want = hinfo.get_chunk_hash(s)
        got_crc = _crc.crc32c(data.tobytes(), 0xFFFFFFFF)
        if hinfo.crc_valid and \
                hinfo.total_chunk_size == st["chunk_len"] and \
                got_crc != want:
            raise ErasureCodeError(
                5, f"recovered shard {s} of {st['oid']} crc mismatch "
                   f"{got_crc:#x} != {want:#x}")

    # objects per recovery sub-batch: bounds both the concurrent survivor
    # read fan-out and the peak survivor-chunk memory (~max * k *
    # chunk_len held at once)
    RECOVER_BATCH_MAX = 64
    # max concatenated byte width of one grouped recovery decode launch
    # (the launch queue enforces the same cap on cross-PG coalescing).
    # A single object's chunk wider than the cap launches alone.
    DECODE_MAX_LAUNCH_W = DECODE_MAX_LAUNCH_W

    def recover_shards_batch(
            self, items: list[tuple[hobject_t, list[int]]],
            push_for: Callable[[hobject_t], Callable]) -> dict:
        """Rebuild many objects' missing shards in as few decode
        launches as the recovery geometry allows.  items: [(oid,
        missing_shards)]; push_for(oid) -> the per-object
        push(shard, data, hinfo) sink.  Returns {oid: None on success
        | the per-object Exception} — one object's failure never blocks
        the rest.  Processed in slices of RECOVER_BATCH_MAX, each one
        recover_shards_submit + recover_shards_finalize."""
        results: dict[hobject_t, Exception | None] = {}
        step = self.RECOVER_BATCH_MAX
        for lo in range(0, len(items), step):
            results.update(self.recover_shards_finalize(
                self.recover_shards_submit(items[lo:lo + step], push_for)))
        return results

    def recover_shards_submit(
            self, items: list[tuple[hobject_t, list[int]]],
            push_for: Callable[[hobject_t], Callable]) -> _Recovery:
        """Submit half of one recovery slice (at most RECOVER_BATCH_MAX
        objects, the reference's _recover_shards_slice up to its
        launches): every object's reads, grouped by geometry, and with
        a launch queue wired every group's decodes or CLAY repair
        submitted without waiting.  A recovery storm over many PGs
        submits every PG's slice before it finalizes any, so the queue
        coalesces their launches across PGs; recover_shards_batch
        finalizes at once, as the reference does.  Without a queue the
        launches run in recover_shards_finalize."""
        if len(items) > self.RECOVER_BATCH_MAX:
            raise ValueError(f"{len(items)} objects in one recovery slice, "
                             f"at most {self.RECOVER_BATCH_MAX}")
        rec = _Recovery(push_for)
        results = rec.results
        states: list[dict] = []
        clay_states: list[dict] = []
        # phase 1: every object's reads in flight before any wait.
        # Single-shard losses of a sub-chunked plugin with a repair
        # lowering take the CLAY path: only the q^{t-1} repair planes of
        # d helpers are read (1/q of each helper chunk).  A loss that
        # the plugin's minimum set repairs from fewer than k helpers
        # (LRC's local group) reads only those helpers
        for oid, missing in items:
            try:
                st = None
                if self._clay_repair_eligible(missing):
                    st = self._start_clay_repair_reads(oid, missing[0])
                if st is not None:
                    clay_states.append(st)
                else:
                    states.append(self._start_recovery_reads(
                        oid, missing, self._local_helpers(missing)))
            except Exception as e:  # noqa: BLE001 — per-object result
                results[oid] = e
        # phase 2 (CLAY): collect plane reads; any helper failure falls
        # back to the full-read decode path for that object
        clay_groups: dict[tuple, list[dict]] = {}
        for st in clay_states:
            st["ready"].wait(timeout=self.read_timeout)
            with st["glock"]:
                complete = not st["failed"] and st["left"] == 0
            if not complete:
                if self.perf:
                    self.perf.inc("ec_clay_repair_fallbacks")
                try:
                    states.append(self._start_recovery_reads(
                        st["oid"], st["missing"]))
                except Exception as e:  # noqa: BLE001 — per-object result
                    results[st["oid"]] = e
                continue
            if self.perf:
                self.perf.inc("ec_repair_helper_bytes",
                              st["helper_bytes"])
            clay_groups.setdefault(
                (st["lost"], st["helpers"], st["chunk_len"]),
                []).append(st)
        for (lost, helpers, _clen), sts in clay_groups.items():
            try:
                rec.clay.append((sts, self._clay_repair_group(
                    lost, helpers, sts)))
            except Exception as e:  # noqa: BLE001 — whole-group launch
                for st in sts:
                    results.setdefault(st["oid"], e)
        # phase 2 (full): collect; drop objects that can't reach k
        # survivors.  A local read short of its helpers re-reads every
        # source shard: the re-read is appended to `states`, so this
        # loop collects it too
        groups: dict[tuple, list[dict]] = {}
        for st in states:
            st["ready"].wait(timeout=self.read_timeout)
            with st["glock"]:
                # snapshot: late on_done callbacks still write into got
                have = dict(st["got"])
            if st["local"] and len(have) < len(st["sources"]):
                if self.perf:
                    self.perf.inc("ec_local_repair_fallbacks")
                try:
                    states.append(self._start_recovery_reads(
                        st["oid"], st["missing"]))
                except Exception as e:  # noqa: BLE001 — per-object result
                    results[st["oid"]] = e
                continue
            if not st["local"] and len(have) < self.k:
                results[st["oid"]] = ErasureCodeError(
                    5, f"cannot recover {st['oid']}: "
                       f"{len(have)} < k={self.k}")
                continue
            st["have"] = have
            if self.perf:
                self.perf.inc("ec_repair_helper_bytes",
                              len(have) * st["chunk_len"])
            survivors = tuple(sorted(have))[: self.k]
            targets = tuple(sorted(st["missing"]))
            erasures = tuple(s for s in range(self.n) if s not in have)
            groups.setdefault((survivors, targets, erasures),
                              []).append(st)
        # phase 3: one decode per geometry group (width-capped slices)
        for (survivors, targets, erasures), sts in groups.items():
            try:
                rec.decode.append((sts, self._decode_recovery_group(
                    survivors, targets, erasures, sts)))
            except Exception as e:  # noqa: BLE001 — whole-group launch
                for st in sts:
                    results.setdefault(st["oid"], e)
        return rec

    def recover_shards_finalize(self, rec: _Recovery) -> dict:
        """Completion half: wait for each group's launches, verify every
        rebuilt shard against its hinfo and push it; returns {oid: None
        | the per-object Exception}."""
        for clay, (sts, rebuilt) in [(True, g) for g in rec.clay] + \
                [(False, g) for g in rec.decode]:
            try:
                per_st = rebuilt()
            except Exception as e:  # noqa: BLE001 — whole-group launch
                for st in sts:
                    rec.results.setdefault(st["oid"], e)
                continue
            if clay and self.perf:
                self.perf.inc("ec_clay_repair_launches")
                self.perf.inc("ec_clay_repairs", len(sts))
            elif self.perf:
                self.perf.inc("ec_local_repairs",
                              sum(st["local"] for st in sts))
            for st, shards in zip(sts, per_st):
                try:
                    push = rec.push_for(st["oid"])
                    for s in st["missing"]:
                        data = np.ascontiguousarray(shards[s]).reshape(-1)
                        self._verify_recovered(st, s, data)
                        push(s, data, st["hinfo"])
                        if self.perf:
                            self.perf.inc("ec_repair_reconstructed_bytes",
                                          data.size)
                except Exception as e:  # noqa: BLE001 — per-object verify
                    rec.results.setdefault(st["oid"], e)
                    continue
                rec.results.setdefault(st["oid"], None)
        return rec.results

    # -- local repair (fewer than k helpers) --------------------------------

    def _local_helpers(self, missing: list[int]) -> tuple[int, ...] | None:
        """The helpers of a repair from fewer than k shards: the
        plugin's minimum set for `missing`, where it names fewer than k
        and the plugin decodes on its device (`decode_chunks_device`:
        the layered LRC's local group).  None for every other plugin
        and loss, which read every source shard."""
        if not hasattr(self.ec_impl, "decode_chunks_device") or \
                self.ec_impl.get_sub_chunk_count() != 1:
            return None
        avail = [s for s in range(self.n) if s not in missing]
        try:
            helpers = self.ec_impl.minimum_to_decode(list(missing), avail)
        except ErasureCodeError:
            return None
        if len(helpers) >= self.k:
            return None
        return tuple(sorted(helpers))

    # -- CLAY plane-read repair ---------------------------------------------

    def _clay_repair_eligible(self, missing: list[int]) -> bool:
        return (self._clay_repair and len(missing) == 1 and
                self.ec_impl.get_sub_chunk_count() > 1 and
                hasattr(self.ec_impl, "repair_matrix"))

    def _clay_plan(self, lost: int, helpers: tuple[int, ...]):
        """Cached ClayRepairPlan for one (lost, helper set) on this
        backend's device: the host plane-solver runs once, every repair
        after is one K4 apply (parallel/mesh.ClayRepairPlan)."""
        key = (lost, helpers)
        plan = self._clay_plans.get(key)
        if plan is None:
            from ..parallel.mesh import ClayRepairPlan
            plan = ClayRepairPlan.build(self.ec_impl, lost, helpers,
                                        device=self.device)
            self._clay_plans[key] = plan
        return plan

    def _start_clay_repair_reads(self, oid: hobject_t,
                                 lost: int) -> dict | None:
        """Phase 1 of a CLAY repair: fan out the repair-plane sub-chunk
        runs of the d chosen helpers without waiting.  Returns None
        when the geometry can't serve the plane path (no helper set,
        chunk not sub-aligned): the caller falls back to full reads."""
        impl = self.ec_impl
        sub = impl.get_sub_chunk_count()
        hinfo = self._get_hinfo(oid)
        chunk_len = None
        for s in range(self.n):
            if s == lost:
                continue
            chunk_len = self.shards.stat(s, oid)
            if chunk_len is not None:
                break
        if chunk_len is None:
            raise ErasureCodeError(5,
                                   f"cannot recover {oid}: no survivor")
        if chunk_len % sub:
            return None
        helpers = impl.choose_helpers(
            lost, set(range(self.n)) - {lost})
        if helpers is None:
            return None
        helpers = tuple(sorted(helpers))
        sub_size = chunk_len // sub
        planes = impl.repair_planes(lost)
        runs = impl._runs(planes)
        row0 = []
        acc = 0
        for _s0, cnt in runs:
            row0.append(acc)
            acc += cnt
        got = {h: np.zeros((len(planes), sub_size), dtype=np.uint8)
               for h in helpers}
        glock = threading.Lock()
        state = {"oid": oid, "missing": [lost], "lost": lost,
                 "helpers": helpers, "hinfo": hinfo,
                 "chunk_len": chunk_len, "sub_size": sub_size,
                 "got": got, "glock": glock, "failed": set(),
                 "left": len(helpers) * len(runs),
                 "helper_bytes": len(helpers) * len(planes) * sub_size,
                 "ready": threading.Event()}

        # one callback closure per run index: on_done only reports the
        # shard, so the run identity must ride the closure
        for ri, (s0, cnt) in enumerate(runs):
            def make_cb(r0=row0[ri], cnt=cnt):
                def cb(sh, d):
                    with glock:
                        if d is None:
                            state["failed"].add(sh)
                        else:
                            if d.size < cnt * sub_size:
                                # sparse tail: pad like the healthy
                                # shard-read path does
                                d = np.concatenate(
                                    [d, np.zeros(cnt * sub_size - d.size,
                                                 dtype=np.uint8)])
                            got[sh][r0:r0 + cnt] = \
                                d.reshape(cnt, sub_size)
                        state["left"] -= 1
                        fire = state["left"] == 0 or state["failed"]
                    if fire:
                        state["ready"].set()
                return cb
            self.shards.sub_read_batch(
                [(h, oid, s0 * sub_size, cnt * sub_size)
                 for h in helpers], make_cb())
        return state

    def _clay_repair_group(self, lost: int, helpers: tuple[int, ...],
                           sts: list[dict]) -> Callable[[], list]:
        """Launch the rebuild of one (lost, helpers) CLAY group: every
        object's stacked helper plane rows ride one launch — the mesh's
        clay_repair_batch when that plane is up, else K4 through the
        per-host launch queue (co-batched with other PGs' repairs) when
        one is wired, the plan's apply_batch otherwise; none has a host
        fallback.  Returns the wait: per object {lost: chunk}."""
        plan = self._clay_plan(lost, helpers)
        rows_list = [
            self.ec_impl.repair_rows(
                lost, {h: st["got"][h] for h in helpers}, helpers)
            for st in sts]
        if self.mesh_codec is not None:
            try:
                rebuilt = self.mesh_codec.clay_repair_batch(plan, rows_list)
            except Exception as e:  # noqa: BLE001 — mesh died mid-storm
                self._disable_mesh(e)
            else:
                if self.perf:
                    self.perf.inc("ec_mesh_repair_launches")
                return lambda: [{lost: r} for r in rebuilt]
        if self._launch_queue is not None:
            big, widths = concat_columns(rows_list)
            ticket = self._launch_queue.submit_clay_repair(
                plan, big, owner=id(self))
            return lambda: [{lost: r} for r in split_columns(
                np.asarray(ticket.result()), widths)]
        return lambda: [{lost: r} for r in plan.apply_batch(rows_list)]

    def _decode_recovery_group(self, survivors, targets, erasures,
                               sts: list[dict]) -> Callable[[], list]:
        """Launch the rebuild of one (survivors, targets) geometry
        group: one mesh decode_flat_batch of every object's survivor
        rows when that plane is up and the group read k of them (a
        local repair's fewer helpers never take it); else width-capped
        concatenated
        decodes, through the launch queue when one is wired so recovery
        decodes coalesce with other PGs'.  Sub-chunked codes (CLAY)
        never take the mesh and decode per object — their plane layout
        does not concatenate along the byte axis.  Returns the wait:
        per object {shard: data} for the targets."""
        erasures = list(erasures)
        if self.mesh_codec is not None and len(survivors) == self.k and \
                self.ec_impl.get_sub_chunk_count() == 1:
            try:
                rows_list = self.mesh_codec.decode_flat_batch(
                    [np.stack([st["have"][s] for s in survivors])
                     for st in sts], survivors, targets)
            except Exception as e:  # noqa: BLE001 — mesh died mid-storm
                # containment: this group and every later one decode on
                # the single-card plane; recovery itself proceeds
                self._disable_mesh(e)
            else:
                if self.perf:
                    self.perf.inc("ec_mesh_repair_launches")
                return lambda: [{s: rows[i] for i, s in enumerate(targets)}
                                for rows in rows_list]
        if self.ec_impl.get_sub_chunk_count() != 1:
            def per_object():
                out = []
                for st in sts:
                    dense = np.zeros((self.n, st["chunk_len"]),
                                     dtype=np.uint8)
                    for s, d in st["have"].items():
                        dense[s] = d
                    dec = self.ec_impl.decode_chunks(dense, erasures)
                    out.append({s: dec[s] for s in targets})
                return out
            return per_object
        slices: list[list[dict]] = []
        cur: list[dict] = []
        cur_w = 0
        for st in sts:
            w = st["chunk_len"]
            if cur and cur_w + w > self.DECODE_MAX_LAUNCH_W:
                slices.append(cur)
                cur, cur_w = [], 0
            cur.append(st)
            cur_w += w
        if cur:
            slices.append(cur)
        launches = []
        try:
            for chunk_sts in slices:
                widths = [st["chunk_len"] for st in chunk_sts]
                big = np.zeros((self.n, sum(widths)), dtype=np.uint8)
                col = 0
                for st, w in zip(chunk_sts, widths):
                    for s, d in st["have"].items():
                        big[s, col:col + w] = d
                    col += w
                launches.append((widths, big if self._launch_queue is None
                                 else self._launch_queue.submit_decode(
                                     self.ec_impl, big, erasures,
                                     owner=id(self))))
        except Exception:
            for _w, t in launches:
                t.cancel()
            raise

        def wait():
            out = []
            for widths, launch in launches:
                dec = np.asarray(launch.result()) \
                    if getattr(launch, "is_launch_ticket", False) \
                    else np.asarray(self.ec_impl.decode_chunks(
                        launch, erasures))
                out.extend({s: part[s] for s in targets}
                           for part in split_columns(dec, widths))
            return out
        return wait

"""The OSD daemon: dispatch, PG backends, shard fan-out, heartbeats.

Re-expresses the reference OSD's runtime shape (src/osd/OSD.{h,cc},
src/ceph_osd.cc): boot = bind messenger + announce to mon + subscribe to
maps (OSD::init, reference OSD.cc:3257); client ops fast-dispatch into
per-PG backends (ms_fast_dispatch -> enqueue_op -> do_request, reference
OSD.cc:6990/9577); EC sub-ops apply shard transactions and ack
(ECBackend::handle_sub_write, reference ECBackend.cc:915); heartbeats
ping peers and report failures to the mon (handle_osd_ping, reference
OSD.cc:5210 + failure_queue :5502).

Idiomatic shifts: the ShardedOpWQ thread-shards collapse into the
messenger's dispatcher pool (Python threads are not the scaling axis
here — the card's codec launch is, and it batches inside ECBackend); the
PG/PeeringState machinery runs full log-based peering on map change
(_peer_pg below: GetLog-style shard interrogation, authoritative-log
selection by min last_update with last_epoch_started fencing, divergent
rollback, stale-shard adoption — the role of the reference's
boost::statechart in src/osd/PeeringState.h, expressed as one
deterministic pass instead of an event machine).

The card: the daemon takes a `device` ("cuda" unless the caller asks
for "cpu"), hands it to the host launch queue and to every ECBackend it
builds, and gives it to a `torch` profile that names none (one that
names a device keeps it).  A CUDA request without a GPU raises where a
PG is built, so that PG's ops fail with the error.  The daemon's own
threads (messenger dispatch, the op pool, recovery passes, scrub, the
batch-window timers) select the device before they reach a codec, as
the launch queue's window worker does.
"""

from __future__ import annotations

import contextlib
import errno
import threading
import time

import numpy as np
import torch

from ..common.tracked_op import NULL_TRACKED, OpTracker, TraceContext
from ..crush.hash import crush_hash32
from ..ec import ErasureCodeError, ErasureCodePluginRegistry, Profile
from ..msg import Messenger
from ..msg import messages as M
from ..osd.osd_map import OSDMap, apply_inc_chain
from ..store import MemStore
from ..store.object_store import ObjectStore, Transaction
from .ec_backend import ECBackend, ShardBackend
from .ec_transaction import PGTransaction, shard_oid
from .ec_util import HINFO_KEY, HashInfo, StripeInfo
from .replicated_backend import ReplicaBackend, ReplicatedBackend
from .types import NO_SHARD, eversion_t, ghobject_t, hobject_t, pg_t, spg_t


class MessengerShardBackend(ShardBackend):
    """ShardBackend over the wire: sub-ops to the acting set's OSDs,
    local shard applied directly (reference try_reads_to_commit's split
    between messenger sends :2074 and local handle_sub_write :2086)."""

    RPC_TIMEOUT = 20.0

    def __init__(self, daemon: "OSDDaemon", pgid: pg_t, acting: list[int]):
        self.daemon = daemon
        self.pgid = pgid
        self.acting = list(acting)
        self.lock = threading.Lock()
        self._tid = 0
        self._pending_writes: dict[int, tuple] = {}
        self._pending_reads: dict[int, tuple] = {}
        self.degraded_shards: set[int] = set()

    def _next_tid(self) -> int:
        with self.lock:
            self._tid += 1
            return self._tid

    def _osd_for(self, shard: int) -> int | None:
        """Acting OSD for a shard; None for holes / down OSDs."""
        from ..crush.map import CRUSH_ITEM_NONE
        osd = self.acting[shard]
        if osd == CRUSH_ITEM_NONE or not self.daemon.osdmap.is_up(osd):
            return None
        return osd

    # -- writes -------------------------------------------------------------

    def sub_write(self, shard, txn, on_commit, log_entries=None,
                  at_version=None, rollforward_to=None, trace=None,
                  top=None):
        from .pg_log import entry_to_wire
        osd = self._osd_for(shard)
        spg = spg_t(self.pgid, shard)
        if osd is None:
            # Hole in the acting set: the shard is degraded; ack now and
            # leave the rebuild to recovery.  Safe only because op
            # admission already enforced pool min_size (live shards >=
            # min_size), mirroring the reference's split between
            # PeeringState min_size gating and degraded-write tolerance.
            self.degraded_shards.add(shard)
            on_commit(shard)
            return
        wire_entries = [entry_to_wire(e) for e in (log_entries or [])]
        if osd == self.daemon.osd_id:
            self.daemon.apply_sub_write(spg, txn, wire_entries,
                                        at_version or eversion_t(),
                                        rollforward_to)
            on_commit(shard)
            return
        tid = self._next_tid()
        with self.lock:
            self._pending_writes[tid] = (on_commit, shard)
        conn = self.daemon.conn_to_osd(osd)
        m = M.MOSDECSubOpWrite(
            spg, tid, at_version or eversion_t(), txn,
            log_entries=wire_entries, rollforward_to=rollforward_to,
            trace=trace)
        if top is not None:
            # wire-plane trace stitch: the msgr ledger stamps
            # msgr_send(peer) on the tracked op once the frame is
            # actually written, so send-queue time is attributable
            m._top = top
        conn.send_message(m)

    def handle_write_reply(self, msg: M.MOSDECSubOpWriteReply) -> None:
        with self.lock:
            ent = self._pending_writes.pop(msg.tid, None)
        if ent:
            on_commit, shard = ent
            # Replies are fast-dispatched on the reactor, but
            # on_commit transitively runs the write pipeline
            # (try_finish_rmw -> check_ops -> possibly a BLOCKING
            # probe() whose stat replies must be delivered by this
            # very loop) — always punt to the dispatch executor.
            Messenger.submit_dispatch(on_commit, shard)

    # -- reads --------------------------------------------------------------

    def sub_read(self, shard, oid, off, length, on_done):
        osd = self._osd_for(shard)
        spg = spg_t(self.pgid, shard)
        if osd is None:
            on_done(shard, None)
            return
        if osd == self.daemon.osd_id:
            data = self.daemon.read_shard(spg, oid, off, length)
            on_done(shard, data)
            return
        tid = self._next_tid()
        with self.lock:
            self._pending_reads[tid] = (on_done, shard)
        conn = self.daemon.conn_to_osd(osd)
        conn.send_message(M.MOSDECSubOpRead(spg, tid, oid, off, length))

    def sub_read_batch(self, reqs, on_done) -> None:
        """Fan out [(shard, oid, off, length), ...] with ONE reactor
        task for all remote sends; the local shard (if any) is read
        after the remote requests are in flight."""
        pairs = []
        local = []
        for shard, oid, off, length in reqs:
            osd = self._osd_for(shard)
            spg = spg_t(self.pgid, shard)
            if osd is None:
                on_done(shard, None)
                continue
            if osd == self.daemon.osd_id:
                local.append((spg, shard, oid, off, length))
                continue
            tid = self._next_tid()
            with self.lock:
                self._pending_reads[tid] = (on_done, shard)
            conn = self.daemon.conn_to_osd(osd)
            pairs.append((conn, M.MOSDECSubOpRead(spg, tid, oid, off,
                                                  length)))
        if pairs:
            self.daemon.messenger.send_batch(pairs)
        for spg, shard, oid, off, length in local:
            on_done(shard, self.daemon.read_shard(spg, oid, off, length))

    def handle_read_reply(self, msg: M.MOSDECSubOpReadReply) -> None:
        with self.lock:
            ent = self._pending_reads.pop(msg.tid, None)
        if ent:
            on_done, shard = ent
            data = (np.frombuffer(msg.data, dtype=np.uint8)
                    if msg.result == 0 else None)
            if getattr(on_done, "loop_safe", False):
                # gather callbacks (store + Event.set) may run inline
                # on the reactor — the hot client-read fan-out path
                on_done(shard, data)
            else:
                # RMW pre-reads continue the write pipeline (decode +
                # encode + possibly blocking probe()): off the loop
                Messenger.submit_dispatch(on_done, shard, data)

    # -- sync metadata RPCs -------------------------------------------------

    def _stat_rpc(self, shard: int, oid: hobject_t, want_attrs: bool
                  ) -> M.MOSDECSubOpReadReply | None:
        osd = self._osd_for(shard)
        spg = spg_t(self.pgid, shard)
        if osd is None:
            return None
        if osd == self.daemon.osd_id:
            return self.daemon.stat_shard(spg, oid, want_attrs)
        tid = self._next_tid()
        box: dict = {}
        ev = threading.Event()

        def on_done_raw(msg):
            box["msg"] = msg
            ev.set()

        with self.lock:
            self._pending_reads[tid] = (None, shard)
            self.daemon.raw_read_waiters[(spg, tid)] = on_done_raw
        conn = self.daemon.conn_to_osd(osd)
        conn.send_message(
            M.MOSDECSubOpRead(spg, tid, oid, 0, 0, want_attrs=want_attrs))
        ev.wait(self.RPC_TIMEOUT)
        with self.lock:
            self._pending_reads.pop(tid, None)
        return box.get("msg")

    def get_hinfo(self, shard, oid):
        reply = self._stat_rpc(shard, oid, want_attrs=True)
        if reply is None or reply.result != 0:
            return None
        raw = reply.attrs.get(HINFO_KEY)
        return HashInfo.decode(raw) if raw else None

    def probe(self, oid, n):
        """(hinfo, shard size) in ONE metadata round: the local shard
        answers without touching the wire (hinfo rides every shard, so
        steady-state writes cost ZERO metadata RPCs), and only a miss
        fans out to the remaining shards CONCURRENTLY — one RTT where
        the sequential sweep cost n (the dominant per-op latency in
        the end-to-end write path)."""
        hinfo = None
        size = None
        remote = []
        for s in range(n):
            osd = self._osd_for(s)
            if osd is None:
                continue
            if osd == self.daemon.osd_id:
                reply = self.daemon.stat_shard(spg_t(self.pgid, s),
                                               oid, True)
                if reply.result == 0:
                    raw = reply.attrs.get(HINFO_KEY)
                    if raw:
                        hinfo = HashInfo.decode(raw)
                    if reply.size >= 0:
                        size = reply.size
            else:
                remote.append((s, osd))
        if hinfo is not None or not remote:
            return hinfo, size
        box: dict = {}
        ev = threading.Event()
        pending = {"n": len(remote)}
        issued: list[tuple] = []
        for s, osd in remote:
            spg = spg_t(self.pgid, s)
            tid = self._next_tid()

            def mk(s=s):
                def cb(msg):
                    with self.lock:   # box is read under this lock
                        box[s] = msg
                        pending["n"] -= 1
                        fire = pending["n"] <= 0
                    if fire:
                        ev.set()
                return cb

            with self.lock:
                self.daemon.raw_read_waiters[(spg, tid)] = mk()
            issued.append((spg, tid))
            try:
                self.daemon.conn_to_osd(osd).send_message(
                    M.MOSDECSubOpRead(spg, tid, oid, 0, 0,
                                      want_attrs=True))
            except Exception:  # noqa: BLE001 - unreachable peer
                with self.lock:
                    pending["n"] -= 1
                    fire = pending["n"] <= 0
                if fire:
                    ev.set()
        ev.wait(self.RPC_TIMEOUT)
        with self.lock:
            for spg, tid in issued:
                self.daemon.raw_read_waiters.pop((spg, tid), None)
            replies = dict(box)   # late callbacks mutate box concurrently
        for s in sorted(replies):
            msg = replies[s]
            if msg.result != 0:
                continue
            if hinfo is None:
                raw = msg.attrs.get(HINFO_KEY)
                if raw:
                    hinfo = HashInfo.decode(raw)
            if size is None and msg.size >= 0:
                size = msg.size
        return hinfo, size

    def get_attrs(self, shard, oid):
        reply = self._stat_rpc(shard, oid, want_attrs=True)
        if reply is None or reply.result != 0:
            return None
        return dict(reply.attrs)

    def stat(self, shard, oid):
        reply = self._stat_rpc(shard, oid, want_attrs=False)
        if reply is None or reply.result != 0 or reply.size < 0:
            return None
        return reply.size


class MessengerReplicaBackend(ReplicaBackend):
    """ReplicaBackend over the wire: replica 0 local, others remote."""

    def __init__(self, daemon: "OSDDaemon", pgid: pg_t, acting: list[int]):
        self.daemon = daemon
        self.pgid = pgid
        self.acting = list(acting)
        self.n_replicas = len(acting)
        self.lock = threading.Lock()
        self._tid = 0
        self._pending: dict[int, tuple] = {}

    def rep_write(self, replica, txn, on_commit):
        from ..crush.map import CRUSH_ITEM_NONE
        osd = self.acting[replica]
        spg = spg_t(self.pgid, NO_SHARD)
        if osd == CRUSH_ITEM_NONE or not self.daemon.osdmap.is_up(osd):
            # down/unplaced replica: not a write target this interval
            # (recovery re-syncs it on return; min_size gating already
            # guaranteed enough live copies before we got here)
            on_commit(replica)
            return
        if osd == self.daemon.osd_id:
            self.daemon.apply_shard_txn(spg, txn)
            on_commit(replica)
            return
        with self.lock:
            self._tid += 1
            tid = self._tid
            self._pending[tid] = (on_commit, replica)
        self.daemon.conn_to_osd(osd).send_message(
            M.MOSDECSubOpWrite(spg, tid, eversion_t(), txn))

    def handle_write_reply(self, msg) -> None:
        with self.lock:
            ent = self._pending.pop(msg.tid, None)
        if ent:
            on_commit, replica = ent
            on_commit(replica)

    def local_read(self, oid, off, length):
        data = self.daemon.read_shard(
            spg_t(self.pgid, NO_SHARD), oid, off,
            length if length is not None else -1)
        import numpy as np
        return data if data is not None else np.empty(0, dtype=np.uint8)

    def local_stat(self, oid):
        reply = self.daemon.stat_shard(spg_t(self.pgid, NO_SHARD),
                                       oid, False)
        return reply.size if reply.result == 0 and reply.size >= 0 else None


class PGState:
    """Per-PG primary-side state: backend + version counter."""

    def __init__(self, backend, kind: str):
        self.backend = backend
        self.kind = kind  # "ec" | "replicated"
        self.version = 0
        self.lock = threading.RLock()   # held across alloc+submit
        # peering: a fresh primary must collect shard logs before
        # serving (reference PeeringState: no ops until Active)
        self.needs_peer = True
        self.peer_lock = threading.Lock()
        # head SnapSet seq cache: steady-state writes under an
        # unchanged SnapContext skip the attrs fetch (only this
        # primary mutates heads, so the cache is authoritative)
        self.snap_seqs: dict = {}

    def next_version(self, epoch: int) -> eversion_t:
        with self.lock:
            self.version += 1
            return eversion_t(epoch, self.version)


class OSDDaemon:
    def __init__(self, osd_id: int, mon_addr,
                 store: ObjectStore | None = None,
                 addr: tuple[str, int] = ("127.0.0.1", 0),
                 heartbeat_interval: float = 0.0,
                 asok_path: str | None = None,
                 auth=None, secure: bool = False,
                 conf: dict | None = None,
                 device: str | torch.device = "cuda"):
        from ..common.context import CephContext
        from ..common.perf_counters import PerfCountersBuilder
        self.osd_id = osd_id
        # where this daemon's EC codecs and launch queue run; resolved
        # where a PG or the queue is built, so a CUDA request without a
        # GPU fails that PG's ops instead of the boot
        self.device = str(device)
        self.cct = CephContext(f"osd.{osd_id}", asok_path)
        # startup conf overrides must land BEFORE anything reads them:
        # options like osd_op_queue choose construction-time shape
        # (the scheduler kind), so post-construction .set() is too late
        for _k, _v in (conf or {}).items():
            self.cct.conf.set(_k, _v)
        self.cct.preload_erasure_code()
        self.perf = self.cct.perf.add(
            PerfCountersBuilder(f"osd.{osd_id}")
            .add_u64_counter("op", "client ops received")
            .add_u64_counter("op_w", "mutating ops")
            .add_u64_counter("op_r", "read ops")
            .add_u64_counter("subop_w", "shard sub-writes applied")
            .add_u64_counter("subop_r", "shard sub-reads served")
            .add_time_avg("op_latency", "client op latency")
            .add_u64_counter("recovery_queued_ops",
                             "rebuild units routed through the "
                             "scheduler's recovery class")
            .add_u64_counter("recovery_pushed_bytes",
                             "rebuilt shard bytes pushed to acting "
                             "homes")
            .add_time_avg("recovery_throttle_wait",
                          "time recovery pushes spent waiting on the "
                          "bandwidth throttle")
            .add_gauge("pg_degraded", "led PGs with recovery pending")
            .add_gauge("pg_misplaced",
                       "objects with split/merge pushes pending")
            .add_gauge("pg_unfound", "objects latched unfound")
            # heartbeat tick-lag detector (evidence for compile-stall
            # heartbeat flaps): how late the last
            # heartbeat tick ran vs osd_heartbeat_interval
            .add_gauge("hb_tick_lag",
                       "seconds the last heartbeat tick ran past "
                       "its osd_heartbeat_interval schedule")
            .add_u64_counter("hb_tick_lag_events",
                             "heartbeat ticks delayed a full extra "
                             "interval or more past schedule (logged)")
            .create_perf_counters())
        # request tracing (reference TrackedOp/OpTracker, docs/
        # TRACING.md): always-on per-op event timelines + per-stage
        # latency histograms; conf observers keep the master switch
        # and complaint time live-tunable (injectargs / pre-boot conf)
        _tconf = self.cct.conf
        self.op_tracker = OpTracker(
            enabled=bool(_tconf.get("osd_enable_op_tracker")),
            complaint_time=float(_tconf.get("osd_op_complaint_time")),
            history_size=int(_tconf.get("osd_op_history_size")),
            history_slow_size=int(
                _tconf.get("osd_op_history_slow_size")),
            perf=self.cct.perf.add(
                PerfCountersBuilder(f"optracker.osd.{osd_id}")
                .create_perf_counters()))

        def _apply_track(_k=None, _v=None):
            self.op_tracker.enabled = bool(
                _tconf.get("osd_enable_op_tracker"))
            self.op_tracker.complaint_time = float(
                _tconf.get("osd_op_complaint_time"))
        for _opt in ("osd_enable_op_tracker", "osd_op_complaint_time"):
            _tconf.add_observer(_opt, _apply_track)
        # device-plane flight recorder (ops/profiler.py, docs/
        # TRACING.md "Device plane"): the HOST singleton — its perf
        # set (lat_launch_* histograms, ec_compile_stalls) registers
        # into exactly ONE daemon's collection per host (the launch-
        # queue rule: re-exporting a shared singleton from every
        # daemon would make sum-across-daemons read n_daemons x the
        # truth), and the same daemon ships the windowed compile
        # report monward for COMPILE_STORM
        from ..ops.profiler import DeviceProfiler
        self._profiler = DeviceProfiler.host_instance()
        self._profiler_reporter = False
        if not getattr(self._profiler, "_perf_registered", False):
            self._profiler._perf_registered = True
            self._profiler_reporter = True
            self.cct.perf.add(self._profiler.perf)
            self._profiler.set_ring_size(
                int(_tconf.get("osd_ec_profiler_ring")))
        # the kernel library cache (ops/compile_cache.py): point the
        # nvcc build directory at the conf's BEFORE the first kernel
        # this daemon launches loads the library — a restarted daemon
        # loads the library built for its source hash and runs no nvcc.
        # One directory per host (first enabler wins, like the profiler
        # perf owner); failures leave the cache off (its status carries
        # the error), never fail boot
        self._prewarm_status: dict | None = None
        if bool(_tconf.get("osd_ec_compile_cache")):
            from ..ops import compile_cache
            compile_cache.enable(
                str(_tconf.get("osd_ec_compile_cache_dir") or "")
                or None)

        def _apply_prof(_k=None, _v=None):
            p = self._profiler
            p.enabled = bool(_tconf.get("osd_ec_profiler"))
            p.stall_s = float(_tconf.get("osd_ec_compile_stall_s"))
            p.storm_window_s = float(
                _tconf.get("osd_ec_compile_storm_window_s"))
            p.inject_stall_s = float(
                _tconf.get("osd_ec_inject_compile_stall") or 0.0)
        _apply_prof()
        for _opt in ("osd_ec_profiler", "osd_ec_compile_stall_s",
                     "osd_ec_compile_storm_window_s",
                     "osd_ec_inject_compile_stall"):
            _tconf.add_observer(_opt, _apply_prof)
        # control-plane flight recorder (osd/pg_ledger.py, docs/
        # TRACING.md "Control plane"): per-DAEMON, not a host
        # singleton — peering/recovery is this daemon's own work, so
        # every daemon registers its own perf set and ships its own
        # MPGStats ledger block (no profiler-style perf-owner rule)
        from .pg_ledger import PGLedger
        self.pg_ledger = PGLedger(
            name=f"pg_ledger.osd.{osd_id}",
            ring=int(_tconf.get("osd_pg_ledger_ring")))
        self.cct.perf.add(self.pg_ledger.perf)

        def _apply_ledger(_k=None, _v=None):
            self.pg_ledger.enabled = bool(
                _tconf.get("osd_pg_ledger"))
        _apply_ledger()
        _tconf.add_observer("osd_pg_ledger", _apply_ledger)
        if self.cct.asok is not None:
            self.cct.asok.register_command(
                "status", lambda cmd: {
                    "osd": self.osd_id,
                    "epoch": self.osdmap.epoch,
                    "num_pgs": len(self.pgs)})
            self.cct.asok.register_command("scrub", self._asok_scrub)
            self.cct.asok.register_command(
                "dump_ops_in_flight", self._asok_dump_ops_in_flight)
            self.cct.asok.register_command(
                "dump_historic_ops",
                lambda cmd: self.op_tracker.dump_historic_ops())
            self.cct.asok.register_command(
                "dump_historic_slow_ops",
                lambda cmd: self.op_tracker.dump_historic_slow_ops())
            # multichip plane state (docs/MULTICHIP.md); both
            # spellings: `ceph daemon ASOK mesh status` and the
            # one-word form
            self.cct.asok.register_command(
                "mesh status", self._asok_mesh_status)
            self.cct.asok.register_command(
                "mesh_status", self._asok_mesh_status)
            # per-host EC launch queue occupancy (cross-PG continuous
            # batching, docs/PIPELINE.md); both spellings like mesh
            self.cct.asok.register_command(
                "launch queue status", self._asok_launch_queue_status)
            self.cct.asok.register_command(
                "launch_queue_status", self._asok_launch_queue_status)
            # repair subsystem state (docs/REPAIR.md); both spellings
            # like mesh/launch-queue
            self.cct.asok.register_command(
                "repair status", self._asok_repair_status)
            self.cct.asok.register_command(
                "repair_status", self._asok_repair_status)
            # device-plane flight recorder (docs/TRACING.md "Device
            # plane"); both spellings like mesh/launch-queue
            self.cct.asok.register_command(
                "launch profile", self._asok_launch_profile)
            self.cct.asok.register_command(
                "launch_profile", self._asok_launch_profile)
            self.cct.asok.register_command(
                "compile ledger", self._asok_compile_ledger)
            self.cct.asok.register_command(
                "compile_ledger", self._asok_compile_ledger)
            # boot-time prewarm state (ops/prewarm.py); both
            # spellings like mesh/launch-queue
            self.cct.asok.register_command(
                "prewarm status", self._asok_prewarm_status)
            self.cct.asok.register_command(
                "prewarm_status", self._asok_prewarm_status)
            # control-plane flight recorder (docs/TRACING.md
            # "Control plane"); both spellings like mesh/launch-queue
            self.cct.asok.register_command(
                "pg ledger", self._asok_pg_ledger)
            self.cct.asok.register_command(
                "pg_ledger", self._asok_pg_ledger)
            # wire-plane flight recorder (docs/TRACING.md "Wire
            # plane"); both spellings like mesh/launch-queue
            self.cct.asok.register_command(
                "messenger status", self._asok_messenger_status)
            self.cct.asok.register_command(
                "messenger_status", self._asok_messenger_status)
            self.cct.asok.register_command(
                "conn profile", self._asok_conn_profile)
            self.cct.asok.register_command(
                "conn_profile", self._asok_conn_profile)
        self.store = store or MemStore()
        self.store.mount()
        self._raw_tid = 1 << 32   # raw-RPC tids, disjoint from backends'
        self.raw_write_waiters: dict = {}
        self.raw_list_waiters: dict = {}
        self._recovered_epochs: set[int] = set()
        self.recovery_enabled = True
        self.prev_osdmap: OSDMap | None = None
        # watch/notify (reference osd/Watch.h:48):
        # (pool, oid.name) -> {cookie: conn}
        self.watchers: dict[tuple, dict[int, object]] = {}
        self._notify_id = 0
        self._notify_pending: dict[int, dict] = {}
        self.osdmap = OSDMap()
        self.map_event = threading.Event()
        self.pgs: dict[pg_t, PGState] = {}
        self.pg_lock = threading.RLock()
        self._batch_armed: dict[int, bool] = {}   # backend -> window armed
        from concurrent.futures import ThreadPoolExecutor
        self._op_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix=f"osd.{osd_id}.op")
        # op scheduler (reference OpScheduler.cc make_scheduler):
        # osd_op_queue=mclock routes client ops through a ShardedOpWQ
        # draining an MClockScheduler — per-class reservation/weight/
        # limit QoS with observable phase + queue-wait counters
        # (mclock.osd.N perf set, docs/QOS.md).  The wpq default keeps
        # the plain executor: same 16-wide worker pool either way.
        self.op_wq = None
        if str(self.cct.conf.get("osd_op_queue")) == "mclock":
            from .scheduler import ShardedOpWQ
            self.op_wq = ShardedOpWQ(
                n_threads=16, kind="mclock", conf=self.cct.conf,
                perf=self.cct.perf.add(
                    PerfCountersBuilder(f"mclock.osd.{osd_id}")
                    .create_perf_counters()))

            def _apply_mclock(_k=None, _v=None):
                self.op_wq.apply_conf(self.cct.conf)
            for _opt in ("osd_mclock_profile",
                         "osd_mclock_custom_profile"):
                self.cct.conf.add_observer(_opt, _apply_mclock)
            if self.cct.asok is not None:
                self.cct.asok.register_command(
                    "dump_mclock", lambda cmd: self.op_wq.dump())
        # PGs whose last recovery pass failed: the steady-state skip
        # must not strand them until an unrelated acting change
        self._pgs_needing_recovery: set = set()
        # led PGs serving with a shard slot that has NO live holder
        # (down-not-out member -> CRUSH_ITEM_NONE hole): everything
        # recoverable is recovered, but redundancy is below target —
        # the reference's active+undersized+degraded.  Counted into
        # MPGStats degraded_pgs (PG_DEGRADED health, mgr progress)
        # and mirrored as an open pg_ledger degraded window; NOT in
        # _pgs_needing_recovery, which gates active+clean waits
        self._pgs_undersized: set = set()
        # recovery passes currently running (quiescence observable for
        # tests/operators: 0 + empty needing-recovery = settled)
        self._recovery_inflight = 0
        self._split_retry_pending = False
        # objects recovery proved unrecoverable with every holder
        # answering (partial writes that never acked, or loss beyond
        # m).  Latched per PG so they stop holding the PG in
        # needing-recovery — the reference's "unfound" state; a later
        # pass re-evaluates (pg_t -> {hobject_t})
        self._unfound: dict[pg_t, set] = {}
        # -- PG split state --------------------------------------------
        # Serializes the local split sweep against shard writes: a
        # sub-write applied concurrently with the sweep could land an
        # object in a parent collection after the sweep passed it, and
        # the shard log mutations (append vs split_out) must not
        # interleave.  Held only across local store work, never across
        # RPCs.  Deliberately one OSD-global lock: the work it covers
        # is Python-level (GIL-bound anyway), and the sweep — the only
        # long holder — is a one-off pause per split, the analog of
        # the reference's pg-lock'd PG::split_into.
        self._split_lock = threading.RLock()
        # child pg -> parent pg recorded when a pool's pg_num grows
        # (the ps-bits ancestry): read/stat fall back through it while
        # a split is settling, and recovery scans ancestor collections
        # for child objects that still sit on pre-split holders
        self._split_ancestry: dict[pg_t, pg_t] = {}
        # (child spg, hobject) moved locally by a split but not yet
        # confirmed on the child's acting home.  The HOLDER drives
        # convergence: a child primary that already ran its recovery
        # pass has no way to learn about objects a lagging holder
        # re-homes later (acked writes racing the map), so the holder
        # pushes and retries until each lands.
        self._split_push_pending: set[tuple[spg_t, hobject_t]] = set()
        self._split_pusher_armed = False
        # PG merge state is deliberately NOT in-memory: dying merge
        # children are derived from the committed map itself
        # (pool.pg_num <= seed < pool.pg_num_max — see _is_dying_pg /
        # _merge_source_pgs), so an OSD that was down across the
        # shrink routes, folds, and recovers identically after revive.
        self.raw_read_waiters: dict = {}
        # shard-resident replicated PG logs (reference: pglog omap keys
        # in the pg meta collection) + peering RPC plumbing
        self.shard_logs: dict = {}
        self.peer_waiters: dict = {}
        # striped per-object op ordering (bounded; rare false sharing
        # is harmless — it only over-serializes)
        self._obj_locks = [threading.Lock() for _ in range(256)]
        self._created_cids: set[spg_t] = set()
        self.heartbeat_interval = heartbeat_interval
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self._hb_last_seen: dict[int, float] = {}
        self._hb_first_ping: dict[int, float] = {}
        # tick-lag detector state: when the previous heartbeat tick
        # STARTED (perf_counter) — a tick that starts much later than
        # interval after its predecessor means the loop was starved
        # (first-bucket XLA compile holding the GIL, load) and peers
        # may be about to report us down
        self._hb_last_tick: float | None = None
        # MPGStats dedup (last report sent + when): unchanged reports
        # re-send only at the osd_pg_stat_keepalive cadence
        self._pgstats_last_sent: dict | None = None
        self._pgstats_last_time = 0.0

        # reactor pool size is a startup option: the class-level pool
        # is created by the FIRST messenger on this host, so the knob
        # must be applied before construction (vstart does the same
        # for in-process clusters; this covers ProcCluster daemons)
        Messenger.configure_pool(
            int(self.cct.conf.get("ms_async_op_threads")))
        self.messenger = Messenger(f"osd.{osd_id}", auth=auth,
                                   secure=secure)
        self.messenger.add_dispatcher(self._dispatch)
        # wire-plane flight recorder (msg/msgr_ledger.py, docs/
        # TRACING.md "Wire plane"): per-daemon wire counters always
        # register (each daemon's own traffic), but the shared
        # MsgrLedger perf set (reactor lag + dispatch histograms)
        # follows the profiler's perf-owner rule — the pool is a host
        # singleton, so exactly ONE daemon per process exports it and
        # ships the monward lag window on MPGStats
        self.cct.perf.add(self.messenger.stats.perf)
        _mled = self.messenger.ledger
        self._msgr_reporter = False
        if not getattr(_mled, "_perf_registered", False):
            _mled._perf_registered = True
            self._msgr_reporter = True
            self.cct.perf.add(_mled.perf)
        # fast dispatch (reference ms_fast_dispatch): the EC data-path
        # RPCs run inline on the reactor — their handlers never block
        # on nested RPCs (shard read = store read + async send; the
        # reply routers hand off to callbacks/events; ping replies
        # inline; MOSDOp's dispatch is just an op-pool submit).
        # Sub-WRITES stay on the executor (store commit may do real
        # I/O on BlueStore/FileStore).
        self.messenger.fast_dispatch = lambda msg: isinstance(
            msg, (M.MOSDOp, M.MOSDECSubOpRead, M.MOSDECSubOpReadReply,
                  M.MOSDECSubOpWriteReply, M.MOSDPing))
        # fault-injection knobs ride the config system so the thrasher
        # (and injectargs at runtime) can set them per daemon
        # (reference ms_inject_* dev options, options.cc:1071-1092)
        conf = self.cct.conf

        def _apply_inject(_k=None, _v=None):
            self.messenger.inject_socket_failures = \
                int(conf.get("ms_inject_socket_failures"))
            self.messenger.inject_delay_prob = \
                float(conf.get("ms_inject_delay_probability"))
            self.messenger.inject_delay_max = \
                float(conf.get("ms_inject_delay_max"))
            self.messenger.compress_algo = \
                str(conf.get("ms_compress")) or None
            self.messenger.compress_min = \
                int(conf.get("ms_compress_min_size"))
            self.messenger.inject_dispatch_stall = \
                float(conf.get("ms_inject_dispatch_stall"))
            self.messenger.sync_timeout = \
                float(conf.get("ms_sync_timeout"))
        _apply_inject()

        def _apply_msgr(_k=None, _v=None):
            led = self.messenger.ledger
            led.enabled = bool(conf.get("ms_ledger"))
            led.set_peer_cap(int(conf.get("ms_ledger_peers")))
            led.probe_interval = float(
                conf.get("ms_reactor_lag_interval"))
            led.warn_s = float(conf.get("ms_reactor_lag_warn_s"))
        _apply_msgr()
        for _opt in ("ms_ledger", "ms_ledger_peers",
                     "ms_reactor_lag_interval",
                     "ms_reactor_lag_warn_s"):
            conf.add_observer(_opt, _apply_msgr)
        # recovery concurrency cap (reference osd_max_backfills
        # reservations): bounds simultaneous per-object rebuilds
        # across this daemon's recovery threads
        self._recovery_sem = threading.BoundedSemaphore(
            max(1, int(conf.get("osd_max_backfills"))))
        # repair-bandwidth throttle (docs/REPAIR.md): token-bucket
        # timestamp shared by every recovery push on this daemon
        self._rec_throttle_lock = threading.Lock()
        self._rec_next_free = 0.0
        for _opt in ("ms_inject_socket_failures",
                     "ms_inject_delay_probability",
                     "ms_inject_delay_max", "ms_compress",
                     "ms_compress_min_size",
                     "ms_inject_dispatch_stall", "ms_sync_timeout"):
            conf.add_observer(_opt, _apply_inject)
        self.addr = self.messenger.bind(addr)
        # one mon or a monmap list (reference MonClient hunting)
        from ..msg.addrs import normalize_mon_addrs
        self.mon_addrs = normalize_mon_addrs(mon_addr)
        self._mon_idx = 0
        self._last_map_time = time.time()
        self.mon_conn = self.messenger.connect(self.mon_addrs[0])

    # -- lifecycle ----------------------------------------------------------

    def boot(self, timeout: float = 10.0) -> None:
        """reference OSD::init + MOSDBoot."""
        self._maybe_prewarm()
        self.mon_conn.send_message(M.MMonGetMap())
        self.mon_conn.send_message(M.MOSDBoot(self.osd_id, self.addr))
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.osdmap.is_up(self.osd_id):
                break
            self.map_event.wait(0.05)
            self.map_event.clear()
        if self.heartbeat_interval > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"osd.{self.osd_id}.hb")
            self._hb_thread.start()
        if bool(self.cct.conf.get("osd_scrub_auto")):
            threading.Thread(
                target=self._scrub_loop, daemon=True,
                name=f"osd.{self.osd_id}.scrub").start()
        # always started: osd_enable_op_tracker is live-tunable, so the
        # surveillance loop must exist even when tracking is off at boot
        threading.Thread(
            target=self._optrack_loop, daemon=True,
            name=f"osd.{self.osd_id}.optrack").start()
        # pg stats: the mon-side `pg stat` / PG_DEGRADED / interleave
        # guard all read these periodic reports
        threading.Thread(
            target=self._pgstats_loop, daemon=True,
            name=f"osd.{self.osd_id}.pgstats").start()

    def shutdown(self) -> None:
        self._hb_stop.set()
        self._op_pool.shutdown(wait=False)
        if self.op_wq is not None:
            self.op_wq.drain_and_stop()
        self.messenger.shutdown()
        self.store.umount()
        self.cct.shutdown()

    def conn_to_osd(self, osd: int):
        info = self.osdmap.osds.get(osd)
        if info is None or info.addr is None:
            raise ErasureCodeError(errno.EHOSTUNREACH, f"osd.{osd} unknown")
        return self.messenger.connect(tuple(info.addr))

    # -- dispatch -----------------------------------------------------------

    def _on_device(self):
        """Select this daemon's card on the calling thread (the current
        CUDA device is per thread); a no-op on the CPU, and where no
        GPU exists, since the codec's own resolve raises there."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and torch.cuda.is_available():
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _dispatch(self, conn, msg) -> None:
        with self._on_device():
            self._dispatch_msg(conn, msg)

    def _dispatch_msg(self, conn, msg) -> None:
        try:
            # privilege fence (reference OSDCap): with auth on, only
            # service-keyed peers (other daemons, the mon) may speak
            # cluster-internal protocol; clients are limited to the
            # public op surface
            if self.messenger.auth is not None:
                ident = getattr(conn.session, "auth_identity", None)
                kind = ident.get("kind") if ident else "none"
                if kind != "service" and not isinstance(
                        msg, (M.MOSDOp, M.MWatchNotify)):
                    return
            if isinstance(msg, M.MMonMap):
                self._handle_map(msg)
            elif isinstance(msg, M.MOSDMapInc):
                self._handle_map_inc(msg)
            elif isinstance(msg, M.MOSDOp):
                # op tracking starts at messenger dispatch: adopt the
                # client's trace context — same span, the op continues
                # across the wire (docs/TRACING.md).  The enabled gate
                # is out here so the off path skips the description
                # f-string and trace decode entirely (zero per-op cost)
                if self.op_tracker.enabled:
                    top = self.op_tracker.create(
                        "osd_op",
                        f"{msg.oid.name} {[op[0] for op in msg.ops]}",
                        TraceContext.from_wire(msg.trace))
                    top.mark_event("msgr_dispatch",
                                   getattr(msg, "recv_stamp", None))
                    # wire-plane stitch: the interval from recv_stamp
                    # (frame off the socket) to here is the messenger
                    # dispatch-queue wait — blamed on msgr_recv_lag so
                    # a starved executor names itself on the timeline
                    if self.messenger.ledger.enabled:
                        top.mark_event("msgr_recv_lag")
                    top.set_info("pg", str(msg.pgid.pgid))
                    # the op's primary IS this OSD (client ops land on
                    # the primary): slow-op reports carry it so the
                    # mon's SLOW_OPS summary blames the op owner even
                    # when a replica's sub-op report arrives first
                    top.set_info("primary", self.osd_id)
                else:
                    top = NULL_TRACKED
                msg.top = top
                # client ops run on the sharded op pool (reference
                # ShardedOpWQ): the messenger awaits each dispatch per
                # connection, so handling inline would serialize every
                # op of a client behind the previous op's COMMIT —
                # no pipelining, and the batch window could never see
                # two ops.  Per-object ordering still comes from the
                # stripe locks in _handle_client_op.
                top.mark_event("queued")
                if self.op_wq is not None:
                    # mclock path: the op class is the client-declared
                    # QoS class riding the wire (dmclock carries client
                    # info the same way) — but only operator-
                    # provisioned, non-internal classes are honored;
                    # everything else collapses into "client"
                    # (ShardedOpWQ.wire_class_ok).
                    # _handle_client_op_safe marks `dequeued`.
                    qc = getattr(msg, "qos", None)
                    if not qc or not self.op_wq.wire_class_ok(qc):
                        qc = "client"
                    self.op_wq.queue(
                        lambda c=conn, m=msg:
                            self._handle_client_op_safe(c, m),
                        op_class=qc)
                else:
                    self._op_pool.submit(self._handle_client_op_safe,
                                         conn, msg)
            elif isinstance(msg, M.MOSDECSubOpWrite):
                self.perf.inc("subop_w")
                # sub-op span: child of the primary's op span, same
                # trace id — the cross-hop stitch point
                if self.op_tracker.enabled:
                    stop = self.op_tracker.create(
                        "ec_sub_write", f"{msg.pgid} tid={msg.tid}",
                        TraceContext.from_wire(msg.trace))
                    stop.set_info("pg", str(msg.pgid.pgid))
                    # a sub-op belongs to the PG's primary: the mon
                    # attributes SLOW_OPS to the op's owner, not to
                    # whichever replica happened to report first
                    try:
                        stop.set_info(
                            "primary",
                            self.osdmap.pg_to_up_acting_osds(
                                msg.pgid.pgid)[3])
                    except Exception:  # noqa: BLE001 - stale/gap map
                        pass
                else:
                    stop = NULL_TRACKED
                try:
                    self.apply_sub_write(msg.pgid, msg.txn,
                                         msg.log_entries,
                                         msg.at_version,
                                         msg.rollforward_to)
                except Exception:
                    stop.mark_event("failed")
                    self.op_tracker.unregister(stop, -errno.EIO)
                    raise
                stop.mark_event("sub_op_applied")
                conn.send_message(M.MOSDECSubOpWriteReply(
                    msg.pgid, msg.tid, msg.pgid.shard))
                self.op_tracker.unregister(stop, 0)
            elif isinstance(msg, M.MPGLogQuery):
                slog = self._shard_log(msg.pgid)
                from .pg_log import entry_to_wire
                conn.send_message(M.MPGLogReply(
                    msg.pgid, msg.tid, slog.info.to_json(),
                    [entry_to_wire(e) for e in slog.log.entries]))
            elif isinstance(msg, M.MPGLogRollback):
                removed = self._shard_log(msg.pgid).rollback_to(msg.v)
                conn.send_message(M.MPGLogRollbackReply(
                    msg.pgid, msg.tid,
                    [M.hobj_to_json(o) for o in removed]))
            elif isinstance(msg, M.MPGActivate):
                self._handle_activate(msg)
                conn.send_message(M.MPGActivateReply(msg.pgid, msg.tid))
            elif isinstance(msg, (M.MPGLogReply, M.MPGLogRollbackReply,
                                  M.MPGActivateReply)):
                waiter = self.peer_waiters.pop((msg.pgid, msg.tid), None)
                if waiter is not None:
                    waiter(msg)
            elif isinstance(msg, M.MOSDECSubOpRead):
                self.perf.inc("subop_r")
                reply = self.stat_shard(msg.pgid, msg.oid,
                                        msg.want_attrs,
                                        msg.want_omap) \
                    if msg.length == 0 else \
                    self._read_reply(msg.pgid, msg.oid, msg.off, msg.length)
                reply.tid = msg.tid
                conn.send_message(reply)
            elif isinstance(msg, M.MOSDECSubOpWriteReply):
                self._route_write_reply(msg)
            elif isinstance(msg, M.MOSDECSubOpReadReply):
                self._route_read_reply(msg)
            elif isinstance(msg, M.MPGList):
                conn.send_message(M.MPGListReply(
                    msg.pgid, msg.tid, self._list_pg_objects(msg.pgid)))
            elif isinstance(msg, M.MPGListReply):
                waiter = self.raw_list_waiters.pop((msg.pgid, msg.tid), None)
                if waiter is not None:
                    waiter(msg)
            elif isinstance(msg, M.MWatchNotify) and msg.is_ack:
                pend = self._notify_pending.get(msg.notify_id)
                if pend is not None:
                    pend["remaining"].discard(msg.cookie)
                    if not pend["remaining"]:
                        pend["event"].set()
            elif isinstance(msg, M.MOSDPing):
                self._handle_ping(conn, msg)
        except Exception as e:  # noqa: BLE001 - daemon must not die
            if isinstance(msg, M.MOSDOp):
                self._reply_op_error(conn, msg, e)
            elif getattr(e, "errno", None) != errno.EAGAIN:
                # cluster-internal paths send no error reply; a
                # swallowed traceback here would hide real bugs
                import traceback
                traceback.print_exc()

    def _apply_mon_config(self, config: dict) -> None:
        """Central config (reference ConfigMonitor/MConfig): the mon
        piggybacks its config_db sections on every map publish; the
        'global' < 'osd' < 'osd.N' sections become this daemon's 'mon'
        config layer, so `ceph config set` / `osd mclock profile set`
        reach running daemons without a restart."""
        merged: dict = {}
        for section in ("global", "osd", f"osd.{self.osd_id}"):
            merged.update(config.get(section, {}))
        try:
            self.cct.conf.apply_mon_layer(merged)
        except Exception:  # noqa: BLE001 - a bad central value must
            # never take the map-handling path down with it
            import traceback
            traceback.print_exc()

    def _handle_map(self, msg: M.MMonMap) -> None:
        self._last_map_time = time.time()
        # config rides every publish, even ones whose osdmap epoch we
        # already have (a pure `config set` doesn't bump the osdmap)
        if "config" in msg.map_json:
            self._apply_mon_config(msg.map_json["config"] or {})
        self._adopt_map(OSDMap.from_json(msg.map_json))

    def _handle_map_inc(self, msg: M.MOSDMapInc) -> None:
        """Incremental map range or keepalive ack (reference the OSD's
        handling of MOSDMap incremental epochs): apply the committed
        delta chain on top of our map — bit-equal to full-map adoption
        — and fall back to an explicit full-map request on any epoch
        gap (we slept past the mon's incremental ring, or the mon's
        optimistic tracking overshot us)."""
        self._last_map_time = time.time()
        # config is authoritative on EVERY send (an emptied config_db
        # must clear the mon layer, exactly like the MMonMap path)
        self._apply_mon_config(msg.config or {})
        if not msg.incs:
            # keepalive: the mon believes we are current.  If it acks
            # an epoch AHEAD of us its tracking overshot (a send we
            # never got) — recover with a full request.
            if msg.epoch > self.osdmap.epoch:
                self._request_full_map()
            else:
                self.map_event.set()
            return
        m = apply_inc_chain(self.osdmap, msg.incs)
        if m is None:               # gap -> explicit full re-request
            self._request_full_map()
            return
        self._adopt_map(m)

    def _request_full_map(self) -> None:
        try:     # have_epoch=0: the mon must answer with a full map
            self.mon_conn.send_message(M.MMonGetMap())
        except Exception:  # noqa: BLE001 - mon hunting handles it
            pass

    def _adopt_map(self, newmap: OSDMap) -> None:
        if newmap.epoch <= self.osdmap.epoch and self.osdmap.epoch:
            self.map_event.set()
            return
        self.prev_osdmap = self.osdmap if self.osdmap.epoch else None
        # peers that (re)joined start their heartbeat clock fresh
        for oid_, o in newmap.osds.items():
            if o.up and not (self.prev_osdmap is not None and
                             self.prev_osdmap.is_up(oid_)):
                self._hb_last_seen.pop(oid_, None)
                self._hb_first_ping.pop(oid_, None)
        # PG split/merge detection: pools whose pg_num changed.
        # Record the ps-bits ancestry BEFORE adopting the map so
        # concurrent reads/stats that miss in a child (split) or
        # parent (merge) collection can already fall back while the
        # sweep runs.
        grown: list[tuple[int, int, int]] = []
        shrunk: list[tuple[int, int, int]] = []
        if self.prev_osdmap is not None:
            for pid, pool in newmap.pools.items():
                old = self.prev_osdmap.pools.get(pid)
                if old is None:
                    continue
                if pool.pg_num > old.pg_num:
                    grown.append((pid, old.pg_num, pool.pg_num))
                    for c in range(old.pg_num, pool.pg_num):
                        self._split_ancestry[pg_t(pid, c)] = \
                            pg_t(pid, c % old.pg_num)
                elif pool.pg_num < old.pg_num:
                    shrunk.append((pid, old.pg_num, pool.pg_num))
        else:
            # first map after (re)boot: a split OR merge may have
            # committed while this OSD was down — its collections
            # would still hold pre-resize placement.  Rehash every
            # pool's local collections and fold any stale
            # beyond-pg_num child collections (no-op when nothing is
            # misplaced; one boot-time hash per local object.  A
            # persisted per-pool pg_num marker could skip this
            # entirely — future work if boot time on large persistent
            # stores ever matters).
            grown = [(pid, pool.pg_num, pool.pg_num)
                     for pid, pool in newmap.pools.items()]
            shrunk = [(pid, pool.pg_num, pool.pg_num)
                      for pid, pool in newmap.pools.items()]
        self.osdmap = newmap
        # refresh acting sets of cached backends; an interval change
        # (acting set differs) forces re-peering before the next op
        # (reference PeeringState start_peering_interval)
        resized_pools = {pid for pid, _o, _n in grown} | \
            {pid for pid, old_n, new_n in shrunk if old_n != new_n}
        with self.pg_lock:
            # dying merge children stop existing: their recovery /
            # unfound bookkeeping must not wedge quiescence
            for pid, old_n, new_n in shrunk:
                if old_n == new_n:
                    continue
                self._pgs_needing_recovery = {
                    p for p in self._pgs_needing_recovery
                    if not (p.pool == pid and p.seed >= new_n)}
                for p in [p for p in self._pgs_undersized
                          if p.pool == pid and p.seed >= new_n]:
                    self._pgs_undersized.discard(p)
                    self.pg_ledger.degraded_close(p)
                for p in [p for p in self._unfound
                          if p.pool == pid and p.seed >= new_n]:
                    self._unfound.pop(p, None)
            for pgid, state in list(self.pgs.items()):
                if pgid.pool in resized_pools:
                    # a resize is a new interval for every PG of the
                    # pool: parents change content, children are born
                    # or die — rebuild (and re-peer) on next use
                    self.pgs.pop(pgid, None)
                    self.pg_ledger.transition(pgid, "interval_change",
                                              epoch=newmap.epoch)
                    continue
                up, acting, _, primary = newmap.pg_to_up_acting_osds(pgid)
                shards = getattr(state.backend, "shards", None) or \
                    getattr(state.backend, "replicas", None)
                if hasattr(shards, "acting"):
                    if list(acting) != list(shards.acting):
                        state.needs_peer = True
                        self.pg_ledger.transition(
                            pgid, "interval_change",
                            epoch=newmap.epoch)
                    shards.acting = list(acting)
                    if state.kind != "ec":
                        # replicated width follows the acting set
                        shards.n_replicas = len(shards.acting)
                if primary != self.osd_id:
                    self.pgs.pop(pgid, None)  # primary moved away
        # a running OSD the map says is down re-announces itself —
        # heartbeat-grace flaps on a loaded host would otherwise leave
        # it marked down forever (reference OSD::_committed_osd_maps
        # re-sends MOSDBoot when !osdmap->is_up(whoami))
        if not self._hb_stop.is_set() and self.osd_id in newmap.osds \
                and not newmap.is_up(self.osd_id):
            try:
                self.mon_conn.send_message(
                    M.MOSDBoot(self.osd_id, self.addr))
            except Exception:  # noqa: BLE001 - mon hunting handles it
                pass
        # split local shard collections BEFORE the recovery pass for
        # this epoch: recovery must see objects in their post-split
        # homes (remote stragglers are found via ancestor scans)
        for pid, old_n, new_n in grown:
            try:
                self._split_pool_collections(pid, new_n)
            except Exception:  # noqa: BLE001 - a failed sweep must not
                # kill dispatch; the misplaced-write/read fallbacks and
                # recovery retries converge the leftovers
                import traceback
                traceback.print_exc()
        # fold dying merge children into their parents, likewise
        # before recovery (the parent primary's pass must see folded
        # objects locally; remote stragglers come via child scans)
        for pid, old_n, new_n in shrunk:
            # boot-time rehash folds silently; a live shrink is a
            # tracked op (docs/TRACING.md `merge` stages)
            top = self.op_tracker.create(
                "merge", f"pool={pid} {old_n}->{new_n}") \
                if old_n != new_n else NULL_TRACKED
            try:
                self._merge_pool_collections(pid, new_n)
                top.mark_event("merge_done")
            except Exception:  # noqa: BLE001 - same containment as
                top.mark_event("failed")        # the split sweep
                import traceback
                traceback.print_exc()
            finally:
                self.op_tracker.unregister(top)
            if old_n == new_n:
                continue      # boot-time rehash, not a live shrink
            # every surviving parent this OSD leads re-runs the wide
            # recovery scan: lagging holders' child collections may
            # still hold acked data the fold hasn't delivered
            with self.pg_lock:
                for seed in range(new_n):
                    pgid = pg_t(pid, seed)
                    try:
                        _, _, _, primary = \
                            newmap.pg_to_up_acting_osds(pgid)
                    except Exception:  # noqa: BLE001
                        continue
                    if primary == self.osd_id:
                        self._pgs_needing_recovery.add(pgid)
                        self.pg_ledger.transition(
                            pgid, "needs_recovery",
                            epoch=newmap.epoch)
        self.map_event.set()
        if self.recovery_enabled and newmap.pools and \
                newmap.epoch not in self._recovered_epochs:
            self._recovered_epochs.add(newmap.epoch)
            # snapshot the previous map NOW: by the time the thread
            # runs, self.prev_osdmap may already be a newer epoch and
            # the changed-acting comparison would look at the wrong
            # interval
            threading.Thread(target=self._recover_epoch,
                             args=(newmap.epoch, self.prev_osdmap),
                             daemon=True,
                             name=f"osd.{self.osd_id}.recovery").start()

    # -- recovery / backfill (reference PeeringState -> Recovering /
    #    Backfilling; ECBackend::continue_recovery_op :570) ----------------

    def _recover_epoch(self, epoch: int, prevmap=None) -> None:
        """After a map change, rebuild any shard the new acting set is
        missing, for every PG this OSD leads.  This is the elastic part
        of the system: mark an OSD out -> CRUSH picks replacements ->
        primaries reconstruct the lost shards onto them."""
        with self.pg_lock:
            self._recovery_inflight += 1
        top = self.op_tracker.create("recovery", f"epoch={epoch}")
        try:
            with self._on_device():
                self._recover_epoch_inner(epoch, prevmap)
            top.mark_event("recovery_done")
        finally:
            self.op_tracker.unregister(top)
            with self.pg_lock:
                self._recovery_inflight -= 1
        # Convergence timer: a failed/partial recovery (split sources
        # lagging, a push that timed out, peers briefly saturated) used
        # to wait for the NEXT map epoch — and a quiet cluster produces
        # none, stranding the PG until an unrelated acting change.
        # Retry on a timer until the set drains — but only for PGs
        # whose acting set is fully up: a retry against a down member
        # can't complete anyway, the revival bumps an epoch that
        # recovers normally, and full-scan retry passes against dead
        # peers starve live traffic mid-thrash.  One pending retry at
        # a time, 5s apart.
        # Armed on CURRENT state, not `epoch == self.osdmap.epoch`: a
        # pass for a stale epoch can be the LAST one to touch the
        # needing set (a newer epoch's pass may already have finished
        # while this one was mid-scan), and skipping the arm then
        # strands the set until an unrelated map change.
        if not self._hb_stop.is_set() and self._pgs_needing_recovery \
                and self._retry_could_help():
            with self.pg_lock:
                if self._split_retry_pending:
                    return
                self._split_retry_pending = True

            def _retry():
                with self.pg_lock:
                    self._split_retry_pending = False
                # recover against the CURRENT epoch: an epoch that
                # landed inside the retry window must not swallow the
                # retry (its own pass may already have run and failed
                # before this timer armed)
                if not self._hb_stop.is_set() and \
                        self._pgs_needing_recovery:
                    self._recover_epoch(self.osdmap.epoch, self.osdmap)

            t = threading.Timer(5.0, _retry)
            t.daemon = True
            t.start()

    def _retry_could_help(self) -> bool:
        """A recovery retry is worth scheduling iff some PG in the
        needing-recovery set has every acting member up."""
        from ..crush.map import CRUSH_ITEM_NONE
        for pgid in list(self._pgs_needing_recovery):
            try:
                _, acting, _, _ = self.osdmap.pg_to_up_acting_osds(pgid)
            except Exception:  # noqa: BLE001
                continue
            if acting and all(o != CRUSH_ITEM_NONE and
                              self.osdmap.is_up(o) for o in acting):
                return True
        return False

    def _recover_epoch_inner(self, epoch: int, prevmap=None) -> None:
        import numpy as np
        from ..store.object_store import Transaction
        # prune needing-recovery/unfound entries for PGs the map no
        # longer has (pool deleted, or a merge folded the child away)
        # or that another OSD now leads (recovery passes only process
        # led PGs, so a non-led entry can never clear) — a stale
        # entry would wedge quiescence forever
        def still_ours(p: pg_t) -> bool:
            pool = self.osdmap.pools.get(p.pool)
            if pool is None or p.seed >= pool.pg_num:
                return False
            try:
                _, _, _, primary = self.osdmap.pg_to_up_acting_osds(p)
            except Exception:  # noqa: BLE001 - unmappable: keep
                return True
            return primary == self.osd_id or primary < 0
        with self.pg_lock:
            self._pgs_needing_recovery = {
                p for p in self._pgs_needing_recovery if still_ours(p)}
            gone_undersized = [p for p in self._pgs_undersized
                               if not still_ours(p)]
            self._pgs_undersized.difference_update(gone_undersized)
            for p in [p for p in self._unfound
                      if p.pool not in self.osdmap.pools or
                      p.seed >= self.osdmap.pools[p.pool].pg_num]:
                self._unfound.pop(p, None)
        for p in gone_undersized:
            # the window moved with the PG (new primary re-opens its
            # own); a window left open here would leak the gauge
            self.pg_ledger.degraded_close(p)
        # peers that time out once in this pass are not probed again:
        # a dead-but-still-up OSD must not cost 3s per object/shard
        unreachable: set[int] = set()
        for pool in list(self.osdmap.pools.values()):
            for seed in range(pool.pg_num):
                if self._hb_stop.is_set():   # daemon shut down mid-pass
                    return
                pgid = pg_t(pool.id, seed)
                try:
                    up, acting, _, primary = \
                        self.osdmap.pg_to_up_acting_osds(pgid)
                except Exception:  # noqa: BLE001
                    continue
                if primary != self.osd_id:
                    continue
                try:
                    if pool.is_erasure():
                        # one reservation per PG recovery (reference
                        # osd_max_backfills: concurrent backfilling PGs)
                        with self._recovery_sem:
                            self._run_recovery_op(
                                lambda: self._recover_ec_pg(
                                    pgid, acting, unreachable, prevmap))
                    else:
                        with self._recovery_sem:
                            self._run_recovery_op(
                                lambda: self._recover_replicated_pg(
                                    pgid, acting, prevmap, unreachable))
                except ErasureCodeError as e:
                    # peering-incomplete (EAGAIN) or similar on ONE PG
                    # must not kill the recovery pass for the rest —
                    # but a later steady-state epoch must retry it.
                    # Re-check leadership on the LIVE map first: if the
                    # primary moved mid-pass ("not primary" EAGAIN),
                    # adding the pg here would re-wedge the needing set
                    # a newer epoch's pass already pruned — and with no
                    # further epochs coming, quiescence never clears.
                    try:
                        _, _, _, cur_primary = \
                            self.osdmap.pg_to_up_acting_osds(pgid)
                    except Exception:  # noqa: BLE001
                        cur_primary = self.osd_id
                    if cur_primary == self.osd_id or cur_primary < 0:
                        self._pgs_needing_recovery.add(pgid)
                    self.cct.dout("osd", 2,
                                  f"recovery of {pgid} deferred: {e}")

    # -- prioritized recovery (docs/REPAIR.md, docs/QOS.md) -----------------

    def _run_recovery_op(self, fn) -> None:
        """Route one background rebuild unit (a PG's recovery pass)
        through the scheduler's `recovery` class: with osd_op_queue=
        mclock the unit dequeues under the recovery reservation/limit
        triple — degraded-object client reads (which arrive as client-
        class ops and reconstruct inline) preempt rebuild work instead
        of queueing behind it.  Without the mClock queue the unit runs
        inline on the recovery pass thread, as before."""
        if self.op_wq is None:
            fn()
            return
        done = threading.Event()
        box: dict = {}

        def thunk():
            try:
                with self._on_device():
                    fn()
            except Exception as e:  # noqa: BLE001 — re-raised below
                box["err"] = e
            finally:
                done.set()
        self.op_wq.queue(thunk, op_class="recovery")
        self.perf.inc("recovery_queued_ops")
        # the pass thread paces on the scheduler: wake periodically so
        # daemon teardown never hangs on a drained queue
        while not done.wait(0.5):
            if self._hb_stop.is_set():
                return
        if "err" in box:
            raise box["err"]

    def _recovery_throttle(self, nbytes: int) -> None:
        """Repair-bandwidth brake on rebuilt-shard pushes: a token
        bucket at osd_recovery_max_bytes_per_sec (0 = unlimited) plus
        the coarse osd_recovery_sleep pause.  Applied ONLY to
        background pushes — reconstruct-on-read serves client reads
        inline and never waits here."""
        import time as _time
        sleep = float(self.cct.conf.get("osd_recovery_sleep") or 0.0)
        rate = int(self.cct.conf.get(
            "osd_recovery_max_bytes_per_sec") or 0)
        wait = sleep
        if rate > 0:
            with self._rec_throttle_lock:
                now = _time.monotonic()
                base = max(now, self._rec_next_free)
                wait += max(0.0, base - now)
                self._rec_next_free = base + nbytes / rate
        if wait <= 0:
            return
        self.perf.tinc("recovery_throttle_wait", wait)
        deadline = _time.monotonic() + wait
        while not self._hb_stop.is_set():
            left = deadline - _time.monotonic()
            if left <= 0:
                break
            _time.sleep(min(left, 0.2))

    def _pg_object_names(self, pgid: pg_t, acting, shard_ids,
                         unreachable: set | None = None) -> set:
        names: set = set()
        for s in shard_ids:
            osd = acting[s] if s < len(acting) else None
            if osd is None:
                continue
            from ..crush.map import CRUSH_ITEM_NONE
            if osd == CRUSH_ITEM_NONE or not self.osdmap.is_up(osd):
                continue
            if unreachable is not None and osd in unreachable:
                continue
            spg = spg_t(pgid, s if len(shard_ids) > 1 else NO_SHARD)
            for oj in self._remote_list(osd, spg,
                                        unreachable=unreachable):
                names.add(M.hobj_from_json(oj))
        # keep only names the ps-bits rule assigns to this PG: while a
        # split settles, a lagging holder's parent collection still
        # lists objects that now belong to children — recovery/scrub of
        # the parent must not adopt them back
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is not None and pool.pg_num:
            names = {h for h in names
                     if crush_hash32(h.key or h.name) % pool.pg_num ==
                     pgid.seed}
        return names

    def _list_pg_objects(self, spg: spg_t) -> list:
        """Enumerate user objects of a shard collection, hiding the
        per-PG log/info meta object (the reference keeps pg metadata in
        a separate meta collection; here it's a reserved name) and
        rollback generations (reference ghobject NO_GEN filtering in
        collection_list)."""
        from .pg_log import PG_META_NAME
        from .types import NO_GEN
        try:
            return [M.hobj_to_json(g.hobj)
                    for g in self.store.list_objects(self._cid(spg))
                    if g.hobj.name != PG_META_NAME
                    and g.generation == NO_GEN]
        except KeyError:
            return []

    def _remote_list(self, osd: int, spg: spg_t,
                     timeout: float = 10.0,
                     unreachable: set | None = None) -> list:
        if self._hb_stop.is_set():
            return []          # daemon shut down: no more RPC waits
        if osd == self.osd_id:
            return self._list_pg_objects(spg)
        if unreachable is not None and osd in unreachable:
            return []
        # the O(peers) cost item 4 names: one remote listing RPC per
        # (shard, candidate holder) per re-peered PG
        self.pg_ledger.count(spg.pgid, "remote_lists")
        with self.pg_lock:
            self._raw_tid += 1
            tid = self._raw_tid
        box: dict = {}
        ev = threading.Event()
        self.raw_list_waiters[(spg, tid)] = \
            lambda m: (box.update(oids=m.oids), ev.set())
        try:
            self.conn_to_osd(osd).send_message(M.MPGList(spg, tid))
        except Exception:  # noqa: BLE001
            return []
        if not ev.wait(timeout) and unreachable is not None:
            unreachable.add(osd)
        return box.get("oids", [])

    def _make_recovery_push(self, pgid: pg_t, acting: list[int],
                            oid: hobject_t):
        """Shared recovery sink: write a rebuilt shard chunk (+ its
        integrity attrs) to its acting home (used by epoch recovery and
        post-peering repair)."""
        from .ec_util import recovery_attrs

        def push(s, data, hinfo):
            # background rebuild pays the repair-bandwidth throttle
            # BEFORE the push so a tiny cap can't be overshot by a
            # burst of already-decoded shards (docs/REPAIR.md).  The
            # ledger times the whole throttle gate (not just the
            # sleep): the blame row's throttle_s is the time pushes
            # spent in the brake, positive whenever pushes ran
            with self.pg_ledger.stage(pgid, "throttle"):
                self._recovery_throttle(int(np.asarray(data).size))
            txn = Transaction()
            goid = shard_oid(oid, s)
            txn.write(goid, 0, data)
            txn.setattrs(goid, recovery_attrs(hinfo, data))
            # count only DELIVERED bytes: a push that times out on a
            # dead peer must not inflate the repair ledger
            with self.pg_ledger.stage(pgid, "push"):
                delivered = self._push_shard_txn(acting[s],
                                                 spg_t(pgid, s), txn)
            if delivered:
                self.perf.inc("recovery_pushed_bytes",
                              int(np.asarray(data).size))
        return push

    def _push_shard_txn(self, osd: int, spg: spg_t, txn,
                        timeout: float = 20.0) -> bool:
        if self._hb_stop.is_set():
            return False
        if osd == self.osd_id:
            self.apply_shard_txn(spg, txn)
            return True
        with self.pg_lock:
            self._raw_tid += 1
            tid = self._raw_tid
        ev = threading.Event()
        self.raw_write_waiters[(spg, tid)] = lambda m: ev.set()
        self.conn_to_osd(osd).send_message(
            M.MOSDECSubOpWrite(spg, tid, eversion_t(), txn))
        return ev.wait(timeout)

    def _remote_read_full(self, osd: int, spg: spg_t, oid: hobject_t,
                          timeout: float = 3.0,
                          unreachable: set | None = None,
                          want_omap: bool = False,
                          stat_only: bool = False):
        if self._hb_stop.is_set():
            return None
        """(data, attrs) — plus (omap, omap_header) when want_omap —
        of a shard object on a specific OSD, or None.  The backfill
        copy path: a moved shard is fetched from its old holder
        verbatim instead of being re-decoded.  stat_only skips the
        data read (data comes back None): attrs and omap ride the
        stat reply, which is all a version probe needs."""
        if osd == self.osd_id:
            goid = ghobject_t(oid, shard=spg.shard)
            try:
                data = None if stat_only else \
                    self.store.read(self._cid(spg), goid)
                if stat_only:
                    self.store.stat(self._cid(spg), goid)
                attrs = self.store.getattrs(self._cid(spg), goid)
                if want_omap:
                    omap = self.store.omap_get(self._cid(spg), goid)
                    hdr = self.store.omap_get_header(self._cid(spg),
                                                     goid)
            except KeyError:
                return None
            if want_omap:
                return (data if data is None else np.asarray(data),
                        attrs, omap, hdr)
            return (data if data is None else np.asarray(data), attrs)
        with self.pg_lock:
            self._raw_tid += 1
            tid = self._raw_tid
        box: dict = {}
        ev = threading.Event()
        self.raw_read_waiters[(spg, tid)] = \
            lambda m: (box.update(msg=m), ev.set())
        try:
            self.conn_to_osd(osd).send_message(
                M.MOSDECSubOpRead(spg, tid, oid, 0, 0, want_attrs=True,
                                  want_omap=want_omap))
        except Exception:  # noqa: BLE001
            return None
        if not ev.wait(timeout):
            if unreachable is not None:
                unreachable.add(osd)
            return None
        stat = box["msg"]
        if stat.result != 0 or stat.size < 0:
            return None
        if stat_only:
            data = None
        elif stat.size == 0:
            data = np.empty(0, dtype=np.uint8)
        else:
            with self.pg_lock:
                self._raw_tid += 1
                tid = self._raw_tid
            box2: dict = {}
            ev2 = threading.Event()
            self.raw_read_waiters[(spg, tid)] = \
                lambda m: (box2.update(msg=m), ev2.set())
            self.conn_to_osd(osd).send_message(
                M.MOSDECSubOpRead(spg, tid, oid, 0, stat.size))
            if not ev2.wait(timeout) or box2["msg"].result != 0:
                return None
            data = np.frombuffer(box2["msg"].data, dtype=np.uint8)
        if want_omap:
            return data, stat.attrs, stat.omap, stat.omap_header
        return data, stat.attrs

    def _recover_ec_pg(self, pgid: pg_t, acting: list[int],
                       unreachable: set | None = None,
                       prevmap=None) -> None:
        from ..crush.map import CRUSH_ITEM_NONE
        from ..store.object_store import Transaction
        state = self._get_pg(pgid)
        if state.kind != "ec":
            return
        be = state.backend
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None:
            return
        self._unfound.pop(pgid, None)   # re-evaluate each pass
        prevmap = prevmap if prevmap is not None else self.prev_osdmap
        prev_acting = None
        if prevmap is not None and pgid.pool in prevmap.pools:
            try:
                _, prev_acting, _, _ = \
                    prevmap.pg_to_up_acting_osds(pgid)
            except Exception:  # noqa: BLE001
                prev_acting = None
            if pgid.seed >= prevmap.pools[pgid.pool].pg_num:
                # split child born this interval: the previous map's
                # CRUSH answer for its seed is not history — force the
                # full scan so objects are pulled off pre-split holders
                prev_acting = None
        if pgid in self._pgs_needing_recovery:
            # retrying (e.g. split sources lagged last pass): the
            # steady-state shortcuts would scan nothing new
            prev_acting = None
        # objects may live on old holders only: list those too.  Map
        # history beyond one epoch isn't kept (the reference consults
        # past_intervals), so when the acting set changed, the shard
        # scan widens to every up OSD — a moved shard is findable
        # wherever CRUSH last put it.  Steady-state (acting == prev)
        # PGs skip the wide scan.
        unreachable = unreachable if unreachable is not None else set()
        if prev_acting is not None and \
                list(prev_acting) == list(acting) and \
                pgid not in self._pgs_needing_recovery and \
                all(o != CRUSH_ITEM_NONE and self.osdmap.is_up(o)
                    for o in acting):
            # steady state: this PG didn't move and every member is
            # up — writes maintain shards synchronously, so there is
            # nothing to recover.  Skipping saves n_shards remote
            # listings per PG per epoch (a map bump for an unrelated
            # pool was costing every OSD a full listing sweep).
            return
        up_osds = [o.id for o in self.osdmap.osds.values()
                   if o.up and o.id not in unreachable]
        self.pg_ledger.transition(pgid, "recovering",
                                  epoch=self.osdmap.epoch)
        with self.pg_ledger.stage(pgid, "scan"):
            names = self._pg_object_names(pgid, acting, range(be.n),
                                          unreachable=unreachable)
            if prev_acting:
                for s, osd in enumerate(prev_acting):
                    if osd != CRUSH_ITEM_NONE and \
                            self.osdmap.is_up(osd) \
                            and osd not in unreachable:
                        for oj in self._remote_list(
                                osd, spg_t(pgid, s),
                                unreachable=unreachable):
                            names.add(M.hobj_from_json(oj))
            # wide scan only for shards whose holder changed or is
            # gone — steady-state shards are already listed from
            # acting above
            def shard_moved(s: int) -> bool:
                cur = acting[s] if s < len(acting) else CRUSH_ITEM_NONE
                if cur == CRUSH_ITEM_NONE or \
                        not self.osdmap.is_up(cur):
                    return True
                if prev_acting is None:
                    return True
                prev = prev_acting[s] if s < len(prev_acting) \
                    else CRUSH_ITEM_NONE
                return prev != cur
            for s in range(be.n):
                if not shard_moved(s):
                    continue
                spg = spg_t(pgid, s)
                known = {acting[s] if s < len(acting) else None,
                         prev_acting[s] if prev_acting and
                         s < len(prev_acting) else None}
                for osd in up_osds:
                    if osd in known:
                        continue
                    for oj in self._remote_list(osd, spg, timeout=3.0):
                        names.add(M.hobj_from_json(oj))
            # split child / merge parent: objects may still sit in
            # ANCESTOR collections (split) or dying-CHILD collections
            # (merge) on holders whose local sweep lags — list those
            # too, keeping only names the ps-bits rule assigns to
            # this PG
            ancestors = (self._split_ancestors(pgid) +
                         self._merge_source_pgs(pgid)) \
                if prev_acting is None else []
            names |= self._names_from_ancestors(pgid, ancestors,
                                                range(be.n),
                                                pool.pg_num,
                                                up_osds, unreachable)
            if pool.pg_num:
                names = {h for h in names
                         if crush_hash32(h.key or h.name) %
                         pool.pg_num == pgid.seed}
        self.pg_ledger.count(pgid, "objects_scanned", len(names))
        all_ok = True
        # decode-needing objects are DEFERRED and rebuilt in one
        # batched pass after the sweep: grouped by recovery geometry,
        # an OSD-loss storm becomes a handful of distributed decode
        # launches on the mesh plane (or concatenated host decodes)
        # instead of a per-object crawl — docs/MULTICHIP.md
        decode_queue: list[tuple] = []
        for oid in names:
            if self._hb_stop.is_set():
                return
            missing = []
            for s, osd in enumerate(acting):
                if osd == CRUSH_ITEM_NONE or not self.osdmap.is_up(osd):
                    continue
                if be.shards.stat(s, oid) is None:
                    missing.append(s)
            if not missing:
                continue
            if not self._recover_object(pgid, acting, be, prev_acting,
                                        up_osds, oid, missing,
                                        unreachable,
                                        src_pgs=[pgid] + ancestors,
                                        decode_queue=decode_queue):
                all_ok = False
        if decode_queue:
            with self.pg_ledger.stage(pgid, "decode"):
                if not self._recover_decode_batch(pgid, acting, be,
                                                  decode_queue):
                    all_ok = False
        if all_ok:
            self._pgs_needing_recovery.discard(pgid)
            self._note_pg_redundancy(pgid, acting, be.n)
        else:
            self._pgs_needing_recovery.add(pgid)
            self.pg_ledger.transition(pgid, "recovery_deferred",
                                      epoch=self.osdmap.epoch)
            self.pg_ledger.degraded_open(pgid)

    def _note_pg_redundancy(self, pgid: pg_t, acting: list[int],
                            width: int) -> None:
        """After a clean recovery pass: a shard slot with no live
        holder (down-not-out member) means the PG serves BELOW full
        redundancy even though nothing more is recoverable — track it
        undersized (MPGStats degraded_pgs) with an open degraded
        window until the map gives the slot a home."""
        from ..crush.map import CRUSH_ITEM_NONE
        holes = len(acting) < width or any(
            o == CRUSH_ITEM_NONE or not self.osdmap.is_up(o)
            for o in acting)
        if holes:
            with self.pg_lock:
                self._pgs_undersized.add(pgid)
            self.pg_ledger.transition(pgid, "active_undersized",
                                      epoch=self.osdmap.epoch)
            self.pg_ledger.degraded_open(pgid)
        else:
            with self.pg_lock:
                self._pgs_undersized.discard(pgid)
            self.pg_ledger.transition(pgid, "clean",
                                      epoch=self.osdmap.epoch)
            self.pg_ledger.degraded_close(pgid)

    def _recover_decode_batch(self, pgid, acting, be,
                              decode_queue: list[tuple]) -> bool:
        """Reconstruct-from-k for every deferred object of one PG in
        grouped decode launches (ECBackend.recover_shards_batch)."""
        try:
            results = be.recover_shards_batch(
                decode_queue,
                lambda oid: self._make_recovery_push(pgid, acting,
                                                     oid))
        except Exception as e:  # noqa: BLE001 — whole-batch failure
            self.cct.dout("osd", 1,
                          f"batched recovery of pg {pgid} failed: "
                          f"{e!r}")
            return False
        ok = True
        for oid, err in results.items():
            if err is None:
                self.pg_ledger.count(pgid, "objects_recovered")
                self.cct.dout("osd", 5,
                              f"recovered {oid.name} of pg {pgid} by "
                              f"batched decode")
            else:
                ok = False
                self.cct.dout("osd", 1,
                              f"recovery of {oid.name} failed: {err!r}")
        return ok

    def _names_from_ancestors(self, pgid: pg_t, ancestors, shard_ids,
                              pg_num: int, up_osds,
                              unreachable) -> set:
        """Child-PG object names still listed under ancestor
        collections on any up OSD (their local split sweeps may lag),
        filtered to the names the ps-bits rule assigns to pgid."""
        names: set = set()
        sids = list(shard_ids)
        for anc in ancestors:
            for s in sids:
                aspg = spg_t(anc, s if len(sids) > 1 else NO_SHARD)
                for osd in up_osds:
                    if unreachable is not None and osd in unreachable:
                        continue
                    for oj in self._remote_list(
                            osd, aspg, timeout=3.0,
                            unreachable=unreachable):
                        h = M.hobj_from_json(oj)
                        if crush_hash32(h.key or h.name) % pg_num == \
                                pgid.seed:
                            names.add(h)
        return names

    def _recover_object(self, pgid, acting, be, prev_acting, up_osds,
                        oid, missing, unreachable=None,
                        src_pgs=None, decode_queue=None) -> bool:
        """Rebuild one object's missing shards: backfill-by-copy from
        any surviving holder, else reconstruct-from-k (runs under the
        osd_max_backfills reservation).  src_pgs lists the PGs whose
        collections may hold the shard (the PG itself plus, after a
        split, its ancestors on not-yet-swept holders).  When
        decode_queue is given, objects needing the decode path are
        appended there instead of decoded inline — the caller rebuilds
        the whole queue in grouped (mesh-collective) launches."""
        # 1: backfill-by-copy from wherever the shard still lives
        # (previous holder first, then any up OSD).  A leftover
        # copy from an older interval could be stale, so candidates
        # must match the authoritative hinfo's chunk crc when one
        # is known (reference verifies pushed chunks the same way,
        # ECBackend.cc:991).
        from ..common import crc32c as _crc
        from ..crush.map import CRUSH_ITEM_NONE
        auth_hinfo = be._fetch_hinfo(oid)
        src_pgs = src_pgs or [pgid]
        still_missing = []
        for s in missing:
            copied = False
            candidates: list[int] = []
            if prev_acting and s < len(prev_acting):
                old = prev_acting[s]
                if old != CRUSH_ITEM_NONE and old != acting[s] and \
                        self.osdmap.is_up(old):
                    candidates.append(old)
            candidates.extend(o for o in up_osds
                              if o != acting[s] and
                              o not in candidates)
            for old in candidates:
                if unreachable is not None and old in unreachable:
                    continue
                got = None
                for src_pg in src_pgs:
                    got = self._remote_read_full(
                        old, spg_t(src_pg, s), oid,
                        unreachable=unreachable)
                    if got is not None:
                        break
                if got is None:
                    continue
                data, attrs = got
                if auth_hinfo is not None and (
                        auth_hinfo.total_chunk_size != data.size or
                        (auth_hinfo.crc_valid and
                         _crc.crc32c(data.tobytes(), 0xFFFFFFFF) !=
                         auth_hinfo.get_chunk_hash(s))):
                    continue   # stale leftover from an older interval
                if auth_hinfo is not None and \
                        not auth_hinfo.crc_valid:
                    # overwritten object: at least require the
                    # candidate to match its own chunk_crc (bitrot)
                    from .ec_util import CHUNK_CRC_KEY
                    cc = (attrs or {}).get(CHUNK_CRC_KEY)
                    if cc is not None and \
                            int.from_bytes(cc, "little") != \
                            _crc.crc32c(data.tobytes(), 0xFFFFFFFF):
                        continue
                txn = Transaction()
                goid = shard_oid(oid, s)
                txn.write(goid, 0, data)
                if attrs:
                    txn.setattrs(goid, attrs)
                # a timed-out push is NOT a recovery: reporting it
                # copied would let the steady-state skip strand the
                # shard until an unrelated acting change
                copied = self._push_shard_txn(acting[s],
                                              spg_t(pgid, s), txn)
                if copied:
                    break
            if not copied:
                still_missing.append(s)
        if not still_missing:
            self.pg_ledger.count(pgid, "objects_recovered")
            self.cct.dout("osd", 5,
                          f"backfilled {oid.name} shards {missing} "
                          f"of pg {pgid} by copy")
            return True
        if len(still_missing) > be.m:
            if not unreachable and all(
                    self.osdmap.is_up(o.id)
                    for o in self.osdmap.osds.values()):
                # every holder in the cluster answered and fewer than
                # k shards exist anywhere: the object is UNFOUND — a
                # partial write that never acked, or loss beyond m.
                # Latch it (reference marks unfound rather than
                # retrying forever); a later pass re-evaluates.
                self._unfound.setdefault(pgid, set()).add(oid)
                self.cct.dout("osd", 1,
                              f"{oid.name}: unfound in pg {pgid} "
                              f"({len(still_missing)} shards beyond "
                              f"m={be.m}, all holders answered)")
                return True
            self.cct.dout("osd", 1,
                          f"{oid.name}: {len(still_missing)} shards "
                          f"unrecoverable in pg {pgid}")
            return False
        # 2: reconstruct-from-k via the EC decode path — deferred to
        # the caller's batched pass when one is running (the storm
        # case: one grouped launch rebuilds the whole queue)
        if decode_queue is not None:
            decode_queue.append((oid, still_missing))
            return True     # outcome decided by the batch pass
        try:
            be.recover_shard(
                oid, still_missing,
                self._make_recovery_push(pgid, acting, oid))
            self.pg_ledger.count(pgid, "objects_recovered")
            self.cct.dout("osd", 5,
                          f"recovered {oid.name} shards "
                          f"{still_missing} of pg {pgid} by decode")
            return True
        except Exception as e:  # noqa: BLE001
            import traceback
            self.cct.dout("osd", 1,
                          f"recovery of {oid.name} failed: {e!r}\n" +
                          traceback.format_exc())
            return False

    @staticmethod
    def _obj_ver(attrs) -> tuple[int, int]:
        """Decode a replicated object's "_v" stamp to (epoch, version);
        unstamped legacy copies sort lowest (ties keep the local copy,
        i.e. pre-stamp behavior)."""
        v = (attrs or {}).get("_v")
        if v is None:
            return (0, 0)
        try:
            if isinstance(v, np.ndarray):
                v = v.tobytes()
            elif isinstance(v, str):
                v = v.encode()
            e, _, n = bytes(v).partition(b".")
            return (int(e), int(n))
        except (ValueError, TypeError):
            return (0, 0)

    def _recover_replicated_pg(self, pgid: pg_t,
                               acting: list[int],
                               prevmap=None,
                               unreachable: set | None = None,
                               force: bool = False) -> None:
        from ..store.object_store import Transaction
        pool = self.osdmap.pools.get(pgid.pool)
        prevmap = prevmap if prevmap is not None else self.prev_osdmap
        unreachable = unreachable if unreachable is not None else set()
        fresh_child = False
        prev_acting = None
        if prevmap is not None and pgid.pool in prevmap.pools:
            fresh_child = pgid.seed >= prevmap.pools[pgid.pool].pg_num
            try:
                _, prev_acting, _, _ = \
                    prevmap.pg_to_up_acting_osds(pgid)
                if not force and not fresh_child and \
                        list(prev_acting) == list(acting) and \
                        pgid not in self._pgs_needing_recovery and \
                        all(self.osdmap.is_up(o) for o in acting):
                    return   # steady state: nothing moved
            except Exception:  # noqa: BLE001
                prev_acting = None
        spg = spg_t(pgid, NO_SHARD)
        self.pg_ledger.transition(pgid, "recovering",
                                  epoch=self.osdmap.epoch)
        scan_timer = self.pg_ledger.stage(pgid, "scan")
        scan_timer.__enter__()
        names = self._pg_object_names(pgid, acting, [0],
                                      unreachable=unreachable)
        # union over all replicas so a primary that lost data also heals
        for r, osd in enumerate(acting):
            if osd != self.osd_id and self.osdmap.is_up(osd) and \
                    osd not in unreachable:
                for oj in self._remote_list(osd, spg,
                                            unreachable=unreachable):
                    names.add(M.hobj_from_json(oj))
        # the PG moved: objects may live ONLY on old holders — a full
        # remap (both replicas changed at once, e.g. a drain step)
        # would otherwise strand them, since the new acting set lists
        # nothing.  Ordinary interval changes list just the DEPARTED
        # holders (the replicated analog of the EC shard_moved scan);
        # a retry/fresh-child pass widens to every up OSD.  Listings
        # share the pass's unreachable cache so a dead-but-marked-up
        # peer costs one timeout, not one per PG.
        ancestors = []
        up_osds = [o.id for o in self.osdmap.osds.values()
                   if o.up and o.id not in unreachable]
        wide = fresh_child or pgid in self._pgs_needing_recovery or \
            prev_acting is None
        scan = [o for o in up_osds if o not in acting] if wide else \
            [o for o in prev_acting
             if o not in acting and self.osdmap.is_up(o) and
             o not in unreachable]
        for osd in scan:
            for oj in self._remote_list(osd, spg, timeout=3.0,
                                        unreachable=unreachable):
                names.add(M.hobj_from_json(oj))
        if wide:
            # split child / merge parent: ancestor and dying-child
            # collections of not-yet-swept holders too
            ancestors = self._split_ancestors(pgid) + \
                self._merge_source_pgs(pgid)
            if pool is not None:
                names |= self._names_from_ancestors(
                    pgid, ancestors, [0], pool.pg_num, up_osds,
                    unreachable)
        if pool is not None and pool.pg_num:
            names = {h for h in names
                     if crush_hash32(h.key or h.name) % pool.pg_num ==
                     pgid.seed}
        scan_timer.__exit__(None, None, None)
        self.pg_ledger.count(pgid, "objects_scanned", len(names))
        all_ok = True
        peers = [o for o in acting
                 if o != self.osd_id and self.osdmap.is_up(o) and
                 o not in unreachable]
        for oid in names:
            if self._hb_stop.is_set():
                return
            goid = ghobject_t(oid, shard=NO_SHARD)
            local = None
            try:
                local = (self.store.read(self._cid(spg), goid),
                         self.store.getattrs(self._cid(spg), goid),
                         self.store.omap_get(self._cid(spg), goid),
                         self.store.omap_get_header(self._cid(spg),
                                                    goid))
            except KeyError:
                pass
            # the primary's OWN copy is not authoritative across an
            # interval change: a revived ex-primary holds stale data
            # while the interim primary holds acked writes.  Compare
            # the per-object "_v" stamp (epoch-first, so interim
            # writes beat a dead primary's last epoch) across every
            # acting holder — stat-only probes, the stamp rides the
            # attrs — and adopt the winner BEFORE pushing; pushing
            # blind used to roll acked overwrites back.
            best = local
            best_ver = self._obj_ver(local[1]) if local else None
            best_osd = None
            for osd in peers:
                if osd in unreachable:   # grown mid-pass: one
                    continue             # timeout, not one per object
                got = self._remote_read_full(osd, spg, oid,
                                             want_omap=True,
                                             stat_only=True,
                                             unreachable=unreachable)
                if got is None:
                    continue
                ver = self._obj_ver(got[1])
                if best is None or ver > best_ver:
                    best, best_ver, best_osd = got, ver, osd
            if best_osd is not None:
                # a peer wins: fetch its data (probe carried none)
                full = self._remote_read_full(best_osd, spg, oid,
                                              want_omap=True,
                                              unreachable=unreachable)
                # the winner vanished between probe and read (moved
                # by a split sweep, or its holder died): fall back to
                # the local copy rather than dropping the object
                best = full if full is not None else local
            if best is None:
                # on no acting holder — pull from a pre-split
                # holder's child/ancestor collection
                if not self._pull_replicated_object(
                        pgid, spg, oid, goid, ancestors, up_osds):
                    all_ok = False
                    continue
                try:
                    best = (self.store.read(self._cid(spg), goid),
                            self.store.getattrs(self._cid(spg), goid),
                            self.store.omap_get(self._cid(spg), goid),
                            self.store.omap_get_header(
                                self._cid(spg), goid))
                except KeyError:
                    # a concurrent split/merge sweep moved the object
                    # out of this collection — someone else's to
                    # recover now; keep the pass alive and let the
                    # retry converge
                    all_ok = False
                    continue
            elif best is not local:
                # a peer holds a newer copy: adopt it locally
                # (remove-then-rewrite so stale longer data or stale
                # omap keys cannot survive underneath)
                data, attrs, omap, omap_hdr = best
                txn = Transaction()
                txn.remove(goid)
                txn.touch(goid)
                if np.asarray(data).size:
                    txn.write(goid, 0, np.asarray(data))
                if attrs:
                    txn.setattrs(goid, attrs)
                if omap:
                    txn.omap_setkeys(goid, omap)
                if omap_hdr:
                    txn.omap_setheader(goid, omap_hdr)
                self.apply_shard_txn(spg, txn)
            data, attrs, omap, omap_hdr = best
            oid_ok = True
            for osd in acting:
                if osd == self.osd_id or not self.osdmap.is_up(osd):
                    continue
                txn = Transaction()
                txn.write(goid, 0, data)
                if attrs:
                    txn.setattrs(goid, attrs)
                # full omap sync: clear first so keys/headers deleted
                # on the primary don't survive on a diverged replica
                txn.omap_clear(goid)
                if omap:
                    txn.omap_setkeys(goid, omap)
                if omap_hdr:
                    txn.omap_setheader(goid, omap_hdr)
                with self.pg_ledger.stage(pgid, "push"):
                    pushed = self._push_shard_txn(osd, spg, txn)
                if not pushed:
                    all_ok = False
                    oid_ok = False
            if oid_ok:
                # replicated "recovered" = reconciled: adopted and/or
                # re-pushed to every live replica without a timeout
                self.pg_ledger.count(pgid, "objects_recovered")
        if all_ok:
            self._pgs_needing_recovery.discard(pgid)
            self._note_pg_redundancy(
                pgid, acting,
                pool.size if pool is not None else len(acting))
        else:
            self._pgs_needing_recovery.add(pgid)
            self.pg_ledger.transition(pgid, "recovery_deferred",
                                      epoch=self.osdmap.epoch)
            self.pg_ledger.degraded_open(pgid)

    def _reconcile_replicated_pg(self, pgid: pg_t,
                                 state: PGState) -> bool:
        """Replicated analog of _peer_pg: before a fresh primary
        serves its first op, reconcile every object with the acting
        set so a revived stale ex-primary cannot serve (or RMW over)
        data older than an interim primary's acked writes.  Returns
        True when the PG is consistent enough to serve."""
        _, acting, _, _ = self.osdmap.pg_to_up_acting_osds(pgid)
        try:
            self._recover_replicated_pg(pgid, list(acting), force=True)
        except Exception as e:  # noqa: BLE001
            self.cct.dout("osd", 1,
                          f"replicated reconcile of {pgid} failed: "
                          f"{e!r}")
            return False
        return pgid not in self._pgs_needing_recovery

    def _pull_replicated_object(self, pgid: pg_t, spg: spg_t,
                                oid: hobject_t, goid: ghobject_t,
                                ancestors, up_osds) -> bool:
        """Fetch a whole replicated object (data + xattrs + omap) from
        any up holder into the local primary collection.  Sources are
        the PG's own collection on any OSD, then ancestor collections
        (split holders whose sweep lags)."""
        from ..store.object_store import Transaction
        for src_pg in [pgid] + list(ancestors):
            sspg = spg_t(src_pg, NO_SHARD)
            for osd in up_osds:
                if osd == self.osd_id:
                    continue
                got = self._remote_read_full(osd, sspg, oid,
                                             want_omap=True)
                if got is None:
                    continue
                data, attrs, omap, omap_hdr = got
                txn = Transaction()
                txn.touch(goid)
                if data.size:
                    txn.write(goid, 0, data)
                if attrs:
                    txn.setattrs(goid, attrs)
                if omap:
                    txn.omap_setkeys(goid, omap)
                if omap_hdr:
                    txn.omap_setheader(goid, omap_hdr)
                self.apply_shard_txn(spg, txn)
                self.cct.dout("osd", 5,
                              f"pulled {oid.name} of pg {pgid} from "
                              f"osd.{osd} ({src_pg})")
                return True
        return False

    # -- PG split (reference PG::split_into / OSD::advance_pg splits;
    #    the ps-bits rule: an object's child PG is hash mod new pg_num,
    #    so with power-of-two stepping parent seed s scatters exactly
    #    into {s + i*old_pg_num}) ------------------------------------------

    def _split_pool_collections(self, pool_id: int, new_n: int) -> None:
        """Rehash every local shard collection of a grown pool: objects
        whose ps-bits now select a child PG move — data, xattrs, omap,
        rollback generations, snap clones — together with their PG log
        entries; the child inherits the parent's info bounds.  Runs
        under the split lock so no sub-write can slip an object into a
        parent collection behind the sweep."""
        with self._split_lock:
            for cid in list(self.store.list_collections()):
                if cid.pgid.pool != pool_id or cid.pgid.seed >= new_n:
                    continue
                # parents are every pre-existing seed; a child created
                # moments ago by another pool grow step is covered too
                # (its objects already rehash to themselves)
                try:
                    self._split_shard_collection(cid, new_n)
                except KeyError:
                    continue   # collection raced away (pg removal)

    def _split_shard_collection(self, cid: spg_t, new_n: int) -> None:
        from .pg_log import PG_META_NAME
        parent_seed = cid.pgid.seed
        gobjs = self.store.list_objects(cid)
        moves: dict[int, list[ghobject_t]] = {}
        for g in gobjs:
            if g.hobj.name == PG_META_NAME:
                continue
            seed = crush_hash32(g.hobj.key or g.hobj.name) % new_n
            if seed != parent_seed:
                moves.setdefault(seed, []).append(g)
        if not moves:
            return
        slog = self._shard_log(cid)
        ptxn = Transaction()
        for child_seed, goids in sorted(moves.items()):
            child = spg_t(pg_t(cid.pgid.pool, child_seed), cid.shard)
            ccid = self._cid(child)
            ctxn = Transaction()
            names = {g.hobj.name for g in goids}
            for g in goids:
                self._stage_object_copy(cid, ctxn, g)
                ptxn.remove(g)
            self.store.queue_transactions(ccid, [ctxn])
            # the child's shard log inherits the entries of its objects
            # plus the parent's last_update/les bounds — that history is
            # what lets child peering fence stale shards exactly like a
            # parent interval change would
            moved_entries = [e for e in slog.log.entries
                             if e.oid.name in names]
            self._shard_log(child).merge_split(
                moved_entries, slog.info.last_update,
                slog.info.last_epoch_started)
            # holder-driven delivery: this OSD now owes these objects
            # to the child's acting home (one hobj per name suffices —
            # the pusher copies every ghobject of the name)
            by_name: dict[str, hobject_t] = {}
            for g in goids:
                by_name.setdefault(g.hobj.name, g.hobj)
            self._queue_split_push(child, set(by_name.values()))
            self.cct.dout("osd", 3,
                          f"split {cid}: {len(goids)} shard objects "
                          f"-> {child}")
        slog.split_out({g.hobj.name
                        for gs in moves.values() for g in gs})
        self.store.queue_transactions(cid, [ptxn])

    def _stage_object_copy(self, src_cid: spg_t, txn: Transaction,
                           g: ghobject_t) -> None:
        """Stage one ghobject's full state (data, xattrs, omap) into a
        transaction bound for another collection, same ghobject id."""
        txn.touch(g)
        data = self.store.read(src_cid, g)
        if data.size:
            txn.write(g, 0, data)
        attrs = self.store.getattrs(src_cid, g)
        if attrs:
            txn.setattrs(g, attrs)
        try:
            omap = self.store.omap_get(src_cid, g)
            hdr = self.store.omap_get_header(src_cid, g)
        except KeyError:
            omap, hdr = {}, b""
        if omap:
            txn.omap_setkeys(g, omap)
        if hdr:
            txn.omap_setheader(g, hdr)

    # -- PG merge (the inverse of the split sweep; reference
    #    PG::merge_from / OSDMonitor pg_num decrease, Nautilus) ------------

    def _merge_pool_collections(self, pool_id: int, new_n: int) -> None:
        """Fold every local shard collection whose seed the shrunk
        pg_num no longer covers into its parent (seed mod new_n):
        data, xattrs, omap, rollback generations and snap clones move,
        the child's shard log unions into the parent's WITHOUT moving
        its peering bounds (`ShardPGLog.fold_in` explains why), and
        the folded objects queue for holder-driven delivery to the
        parent's acting home.  Runs under the split lock — a concurrent
        sub-write must not land in a child collection behind the
        fold."""
        with self._split_lock:
            for cid in list(self.store.list_collections()):
                if cid.pgid.pool != pool_id or cid.pgid.seed < new_n:
                    continue
                try:
                    self._merge_shard_collection(cid, new_n)
                except KeyError:
                    continue   # collection raced away

    def _merge_shard_collection(self, cid: spg_t, new_n: int) -> None:
        from .pg_log import PG_META_NAME
        parent = spg_t(pg_t(cid.pgid.pool, cid.pgid.seed % new_n),
                       cid.shard)
        gobjs = [g for g in self.store.list_objects(cid)
                 if g.hobj.name != PG_META_NAME]
        slog = self._shard_log(cid)
        if gobjs:
            pcid = self._cid(parent)
            ctxn = Transaction()
            by_name: dict[str, hobject_t] = {}
            for g in gobjs:
                self._stage_object_copy(cid, ctxn, g)
                by_name.setdefault(g.hobj.name, g.hobj)
            self.store.queue_transactions(pcid, [ctxn])
            # this OSD now owes the folded objects to the parent's
            # acting home under the new map — same holder-driven
            # delivery as a split (_queue_split_push pushes from
            # whatever collection the target pgid names)
            self._queue_split_push(parent, set(by_name.values()))
            self.cct.dout("osd", 3,
                          f"merge {cid}: {len(gobjs)} shard objects "
                          f"-> {parent}")
        # log union, bounds-preserving (see ShardPGLog.fold_in for why
        # the parent's peering bounds must not ratchet): child entries
        # above the bound travel as unlogged backfill data instead
        # (push + wide recovery scan), the proven split-push path
        self._shard_log(parent).fold_in(list(slog.log.entries))
        # the child is dead: drop its collection and log state so a
        # later re-grow starts from a clean slate
        with self.pg_lock:
            self.shard_logs.pop(cid, None)
        try:
            self.store.remove_collection(cid)
        except KeyError:
            pass
        self._created_cids.discard(cid)

    def _is_dying_pg(self, pgid: pg_t) -> bool:
        """A merge child the current map has folded away: its seed is
        beyond the pool's pg_num but within the committed historical
        maximum (OSDMap pg_num_max) — derivable on ANY osd, including
        one that slept through the shrink."""
        pool = self.osdmap.pools.get(pgid.pool)
        return pool is not None and \
            pool.pg_num <= pgid.seed < pool.pg_num_ever()

    def _merge_source_pgs(self, pgid: pg_t) -> list[pg_t]:
        """Dying children (across stacked shrinks too: every retired
        seed congruent to pgid mod pg_num) that fold into pgid — the
        collections recovery/reads consult while a merge settles.
        Map-derived, so it survives reboots."""
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None or not pool.pg_num or \
                pgid.seed >= pool.pg_num:
            return []
        return [pg_t(pgid.pool, s)
                for s in range(pgid.seed + pool.pg_num,
                               pool.pg_num_ever(), pool.pg_num)]

    @staticmethod
    def _txn_hobjs(txn: Transaction) -> set[hobject_t]:
        out: set[hobject_t] = set()
        for op in txn.ops:
            for attr in ("oid", "src", "dst"):
                goid = getattr(op, attr, None)
                if goid is not None:
                    out.add(goid.hobj)
        return out

    def _migrate_misplaced(self, spg: spg_t,
                           hobjs: set[hobject_t]) -> None:
        """Post-apply split routing for writes that raced a pg_num
        grow: a sub-write issued against the parent PG by a primary on
        the old map applies verbatim (log append included), then any
        object that rehashes into a child under THIS osd's map moves
        immediately.  Caller holds the split lock."""
        from .pg_log import PG_META_NAME
        pool = self.osdmap.pools.get(spg.pgid.pool)
        if pool is None or not pool.pg_num:
            return
        for hobj in hobjs:
            if hobj.name == PG_META_NAME:
                continue
            seed = crush_hash32(hobj.key or hobj.name) % pool.pg_num
            if seed == spg.pgid.seed:
                continue
            if spg.pgid.seed >= pool.pg_num and \
                    not self._is_dying_pg(spg.pgid):
                # WE are behind the writer's map (a child sub-write
                # arriving before our split sweep): leave it — our own
                # sweep re-homes everything when the new map lands.
                # (A recorded merge ancestor means the opposite: the
                # WRITER is behind and this child is dying — fall
                # through and fold the write into the parent now.)
                continue
            cid = self._cid(spg)
            child = spg_t(pg_t(spg.pgid.pool, seed), spg.shard)
            ccid = self._cid(child)
            goids = [g for g in self.store.list_objects(cid)
                     if g.hobj.name == hobj.name]
            if not goids:
                continue
            ctxn = Transaction()
            for g in goids:
                self._stage_object_copy(cid, ctxn, g)
            self.store.queue_transactions(ccid, [ctxn])
            slog = self._shard_log(spg)
            moved = slog.split_out({hobj.name})
            if self._is_dying_pg(spg.pgid):
                # merge direction (dying child -> parent): bounds-
                # preserving fold — the write's data still travels
                # via the push below
                self._shard_log(child).fold_in(moved)
            else:
                # split direction: the child inherits the parent's
                # bounds (uniform across holders — every parent
                # shard's log carries the same lineage)
                self._shard_log(child).merge_split(
                    moved, slog.info.last_update,
                    slog.info.last_epoch_started)
            ptxn = Transaction()
            for g in goids:
                ptxn.remove(g)
            self.store.queue_transactions(cid, [ptxn])
            # a write acked through the OLD primary after the child
            # primary's recovery pass already ran has no other way to
            # reach the child's acting home — the holder delivers it
            self._queue_split_push(child, {hobj})

    def _queue_split_push(self, child: spg_t,
                          hobjs: set[hobject_t]) -> None:
        """Remember objects this OSD re-homed into a child collection
        until they are confirmed on the child's acting home, and arm
        the pusher."""
        from .pg_log import PG_META_NAME
        with self.pg_lock:
            for h in hobjs:
                if h.name != PG_META_NAME:
                    self._split_push_pending.add((child, h))
            if not self._split_push_pending or self._split_pusher_armed:
                return
            self._split_pusher_armed = True
        t = threading.Timer(0.2, self._drain_split_pushes)
        t.daemon = True
        t.start()

    def _drain_split_pushes(self) -> None:
        """Deliver locally re-homed split objects to the child's
        acting set; whatever cannot land yet (target down, acting
        hole) retries on a timer until the queue drains."""
        if self._hb_stop.is_set():
            with self.pg_lock:
                self._split_pusher_armed = False
            return
        with self.pg_lock:
            pending = list(self._split_push_pending)
        for child, hobj in pending:
            if self._hb_stop.is_set():
                break
            try:
                done = self._push_split_object(child, hobj)
            except Exception:  # noqa: BLE001 - keep the queue alive
                done = False
            if done:
                with self.pg_lock:
                    self._split_push_pending.discard((child, hobj))
        with self.pg_lock:
            more = bool(self._split_push_pending) and \
                not self._hb_stop.is_set()
            if not more:
                self._split_pusher_armed = False
        if more:
            t = threading.Timer(2.0, self._drain_split_pushes)
            t.daemon = True
            t.start()

    def _push_split_object(self, child: spg_t, hobj: hobject_t) -> bool:
        """Copy one re-homed object (all its ghobjects) from the local
        child collection to where the child PG actually lives under
        the CURRENT map.  EC: this OSD held shard `child.shard` of the
        parent, so exactly the same shard of the child is its to
        deliver.  Replicated: the full object goes to every acting
        replica.  True = nothing left to deliver."""
        from ..crush.map import CRUSH_ITEM_NONE
        pool = self.osdmap.pools.get(child.pgid.pool)
        if pool is None or child.pgid.seed >= pool.pg_num:
            if pool is not None and self._is_dying_pg(child.pgid):
                # the target child died in a merge: the fold sweep
                # moved its objects to the parent and queued parent
                # pushes — this entry is superseded, not stuck
                return True
            return pool is None   # pool gone: drop; map lag: retry
        cid = self._cid(child)
        goids = [g for g in self.store.list_objects(cid)
                 if g.hobj.name == hobj.name]
        if not goids:
            return True           # deleted / re-homed again meanwhile
        try:
            _, acting, _, _ = self.osdmap.pg_to_up_acting_osds(
                child.pgid)
        except Exception:  # noqa: BLE001 - unmapped pg: retry later
            return False
        if pool.is_erasure():
            s = child.shard
            if s < 0 or s >= len(acting):
                return True       # shard position no longer exists
            tgt = acting[s]
            if tgt == CRUSH_ITEM_NONE or not self.osdmap.is_up(tgt):
                return False      # hole/down: retry when it heals
            targets = [tgt]
        else:
            targets = [o for o in acting if o != CRUSH_ITEM_NONE and
                       self.osdmap.is_up(o)]
            if len(targets) < len(acting) or not targets:
                return False      # push to the FULL set or retry
        ok_all = True
        for tgt in targets:
            if tgt == self.osd_id:
                continue          # already local
            txn = Transaction()
            for g in goids:
                self._stage_object_copy(cid, txn, g)
            if not self._push_shard_txn(tgt, child, txn, timeout=10.0):
                ok_all = False
        return ok_all

    def _fallback_spgs(self, spg: spg_t,
                       oid: hobject_t | None = None) -> list[spg_t]:
        """Where a shard object may still live while a split or merge
        settles, in probe order: the recorded split parent (this OSD
        already split), the seed the LOCAL pg_num folds the request
        to (this OSD's map predates the child entirely), the seed the
        OBJECT hashes to under the local pg_num (this OSD's map
        predates a merge — the object still sits in the old child
        collection), and any recorded dying merge children of the
        requested PG (local fold pending or mid-flight)."""
        out: list[spg_t] = []

        def add(pg: pg_t) -> None:
            cand = spg_t(pg, spg.shard)
            if cand != spg and cand not in out:
                out.append(cand)

        anc = self._split_ancestry.get(spg.pgid)
        if anc is not None:
            add(anc)
        pool = self.osdmap.pools.get(spg.pgid.pool)
        if pool is not None and pool.pg_num:
            if spg.pgid.seed >= pool.pg_num:
                add(pg_t(spg.pgid.pool,
                         spg.pgid.seed % pool.pg_num))
            if oid is not None:
                add(pg_t(spg.pgid.pool,
                         crush_hash32(oid.key or oid.name) %
                         pool.pg_num))
        for child in self._merge_source_pgs(spg.pgid):
            add(child)
        return out

    def _split_ancestors(self, pgid: pg_t) -> list[pg_t]:
        """The ancestry chain of a child PG (oldest last), empty for
        PGs that never split out."""
        out: list[pg_t] = []
        cur = self._split_ancestry.get(pgid)
        while cur is not None and cur not in out and cur != pgid:
            out.append(cur)
            cur = self._split_ancestry.get(cur)
        return out

    # -- shard-side ops (any OSD) ------------------------------------------

    def _cid(self, spg: spg_t) -> spg_t:
        if spg not in self._created_cids:
            self.store.create_collection(spg)
            self._created_cids.add(spg)
        return spg

    def apply_shard_txn(self, spg: spg_t, txn: Transaction) -> None:
        with self._split_lock:
            self.store.queue_transactions(self._cid(spg), [txn])
            self._migrate_misplaced(spg, self._txn_hobjs(txn))

    def _shard_log(self, spg: spg_t):
        from .pg_log import ShardPGLog
        with self.pg_lock:
            slog = self.shard_logs.get(spg)
            if slog is None:
                slog = self.shard_logs[spg] = ShardPGLog(
                    self.store, self._cid(spg), spg.shard)
            return slog

    def apply_sub_write(self, spg: spg_t, txn: Transaction,
                        wire_entries: list, at_version: eversion_t,
                        rollforward_to: eversion_t | None) -> None:
        """Shard write + atomic log persistence (reference
        ECBackend::handle_sub_write, ECBackend.cc:915: the log entries
        ride the same ObjectStore transaction as the data)."""
        from .pg_log import entry_from_wire
        if not wire_entries:
            self.apply_shard_txn(spg, txn)
            return
        entries = [entry_from_wire(w) for w in wire_entries]
        with self._split_lock:
            slog = self._shard_log(spg)
            slog.append_to_txn(txn, entries, at_version)
            self.store.queue_transactions(self._cid(spg), [txn])
            slog.record(entries, at_version)
            from .ec_util import refresh_chunk_crcs
            refresh_chunk_crcs(self.store, self._cid(spg), spg.shard,
                               entries)
            if rollforward_to is not None:
                slog.advance_rollforward(rollforward_to)
            self._migrate_misplaced(spg, {e.oid for e in entries})

    def _handle_activate(self, msg: M.MPGActivate) -> None:
        from .pg_log import entry_from_wire
        slog = self._shard_log(msg.pgid)
        if msg.adopt:
            slog.adopt([entry_from_wire(w) for w in msg.entries],
                       msg.head, msg.les)
        else:
            slog.set_les(msg.les)

    def read_shard(self, spg: spg_t, oid: hobject_t, off: int,
                   length: int) -> np.ndarray | None:
        goid = ghobject_t(oid, shard=spg.shard)
        try:
            data = self.store.read(self._cid(spg), goid, off,
                                   None if length < 0 else length)
        except KeyError:
            # split/merge settling: the object may still sit in a
            # parent or dying-child collection (local sweep pending,
            # or this OSD's map is older than the requester's)
            data = None
            for fb in self._fallback_spgs(spg, oid):
                if not self.store.collection_exists(fb):
                    continue
                try:
                    data = self.store.read(
                        fb, goid, off,
                        None if length < 0 else length)
                    break
                except KeyError:
                    continue
            if data is None:
                return None
        if length > 0 and data.size < length:
            data = np.concatenate(
                [data, np.zeros(length - data.size, dtype=np.uint8)])
        return data

    def _read_reply(self, spg, oid, off, length) -> M.MOSDECSubOpReadReply:
        data = self.read_shard(spg, oid, off, length)
        if data is None:
            return M.MOSDECSubOpReadReply(spg, 0, spg.shard, -errno.ENOENT)
        return M.MOSDECSubOpReadReply(spg, 0, spg.shard, 0, data.tobytes())

    def stat_shard(self, spg, oid, want_attrs,
                   want_omap: bool = False) -> M.MOSDECSubOpReadReply:
        goid = ghobject_t(oid, shard=spg.shard)
        cid = self._cid(spg)
        try:
            size = self.store.stat(cid, goid)
        except KeyError:
            size = None
            for fb in self._fallback_spgs(spg, oid):  # resize settling
                if not self.store.collection_exists(fb):
                    continue
                try:
                    size = self.store.stat(fb, goid)
                    cid = fb
                    break
                except KeyError:
                    continue
            if size is None:
                return M.MOSDECSubOpReadReply(
                    spg, 0, spg.shard, -errno.ENOENT)
        attrs = self.store.getattrs(cid, goid) if want_attrs else {}
        omap: dict = {}
        omap_hdr = b""
        if want_omap:
            try:
                omap = self.store.omap_get(cid, goid)
                omap_hdr = self.store.omap_get_header(cid, goid)
            except KeyError:
                pass
        return M.MOSDECSubOpReadReply(spg, 0, spg.shard, 0, b"",
                                      attrs, size, omap=omap,
                                      omap_header=omap_hdr)

    def _route_write_reply(self, msg) -> None:
        waiter = self.raw_write_waiters.pop((msg.pgid, msg.tid), None)
        if waiter is not None:
            waiter(msg)
            return
        with self.pg_lock:
            state = self.pgs.get(msg.pgid.pgid)
        if state is None:
            return
        be = state.backend
        tgt = be.shards if state.kind == "ec" else be.replicas
        tgt.handle_write_reply(msg)

    def _route_read_reply(self, msg) -> None:
        waiter = self.raw_read_waiters.pop((msg.pgid, msg.tid), None)
        if waiter is not None:
            waiter(msg)
            return
        with self.pg_lock:
            state = self.pgs.get(msg.pgid.pgid)
        if state is not None and state.kind == "ec":
            state.backend.shards.handle_read_reply(msg)

    # -- primary-side client ops -------------------------------------------

    def _get_pg(self, pgid: pg_t) -> PGState:
        with self.pg_lock:
            state = self.pgs.get(pgid)
            if state is None:
                pool = self.osdmap.pools[pgid.pool]
                up, acting, _, primary = \
                    self.osdmap.pg_to_up_acting_osds(pgid)
                if primary != self.osd_id:
                    raise ErasureCodeError(
                        errno.EAGAIN,
                        f"not primary for {pgid} (is {primary})")
                if pool.is_erasure():
                    prof = self._with_device(self.osdmap.ec_profiles[
                        pool.erasure_code_profile])
                    codec = ErasureCodePluginRegistry.instance().factory(
                        prof["plugin"], Profile(prof))
                    k = codec.get_data_chunk_count()
                    sinfo = StripeInfo(pool.stripe_width,
                                       pool.stripe_width // k)
                    shards = MessengerShardBackend(self, pgid, acting)
                    backend = ECBackend(
                        codec, sinfo, shards,
                        mesh_service=self._mesh_service(),
                        launch_queue=self._host_launch_queue(),
                        dispatch_depth=int(self.cct.conf.get(
                            "ec_dispatch_ahead_depth") or 2),
                        perf_name=f"ec.{pgid}",
                        logger=lambda msg: self.cct.dout(
                            "osd", 1, msg),
                        read_timeout=float(self.cct.conf.get(
                            "osd_ec_read_timeout") or 30.0),
                        clay_repair=bool(self.cct.conf.get(
                            "osd_ec_clay_repair")),
                        # the codec's device where it has one (a torch
                        # profile naming its own); the daemon's for a
                        # host codec's own device work (CLAY repair
                        # plans)
                        device=getattr(codec, "device", None)
                        or self.device)
                    # surface the backend's pipeline counters in this
                    # daemon's `perf dump` / prometheus scrape
                    self.cct.perf.add(backend.perf)
                    if bool(self.cct.conf.get("ec_dispatch_ahead")):
                        backend.set_pipelined(float(self.cct.conf.get(
                            "ec_dispatch_flush_ms") or 2.0))
                    state = PGState(backend, "ec")
                else:
                    replicas = MessengerReplicaBackend(self, pgid, acting)
                    backend = ReplicatedBackend(replicas)
                    state = PGState(backend, "replicated")
                self.pgs[pgid] = state
        # Peer outside pg_lock: the shard-log RPCs must not stall every
        # other PG's dispatch (reference peering happens in its own
        # state machine, ops wait on Active).  EC PGs reconcile shard
        # logs; replicated PGs reconcile object versions — without it a
        # revived stale ex-primary serves (and RMWs over) data older
        # than the interim primary's acked writes before background
        # recovery gets to the PG.
        if state.needs_peer:
            with state.peer_lock:
                if state.needs_peer:
                    # incomplete peering (a live shard didn't answer)
                    # keeps needs_peer set: the next op retries until
                    # every live shard's log has been reconciled
                    self.pg_ledger.transition(
                        pgid,
                        "peering" if state.kind == "ec"
                        else "reconcile",
                        epoch=self.osdmap.epoch)
                    with self.pg_ledger.stage(pgid, "peering"):
                        ok = self._peer_pg(pgid, state) \
                            if state.kind == "ec" else \
                            self._reconcile_replicated_pg(pgid, state)
                    state.needs_peer = not ok
                    self.pg_ledger.transition(
                        pgid, "active" if ok else "peering_incomplete",
                        epoch=self.osdmap.epoch)
            if state.needs_peer:
                # Never serve ops from an unpeered PG: a partial view
                # could miss acked writes held by the silent shard.
                raise ErasureCodeError(
                    errno.EAGAIN,
                    f"pg {pgid} peering incomplete; retry")
        return state

    # -- peering (reference PeeringState.cc GetInfo/GetLog/Activate:
    #    collect shard logs, pick the authoritative one, reconcile) ---------

    def _peer_rpc(self, osd: int, spg: spg_t, msg_cls,
                  timeout: float = 5.0, **kw):
        """One synchronous peering RPC to a remote shard; None on
        timeout/unreachable (the shard is then treated as down)."""
        with self.pg_lock:
            self._raw_tid += 1
            tid = self._raw_tid
        box: dict = {}
        ev = threading.Event()
        self.peer_waiters[(spg, tid)] = \
            lambda m: (box.update(msg=m), ev.set())
        try:
            self.conn_to_osd(osd).send_message(msg_cls(spg, tid, **kw))
        except Exception:  # noqa: BLE001
            self.peer_waiters.pop((spg, tid), None)
            return None
        if not ev.wait(timeout):
            self.peer_waiters.pop((spg, tid), None)
            return None
        return box.get("msg")

    def _peer_pg(self, pgid: pg_t, state: PGState) -> bool:
        """Authoritative-log peering for one EC PG this OSD now leads.
        Returns False when a live shard could not be reconciled (the
        caller must retry before trusting the PG).

        1. GetLog: every live shard reports (pg_info, log entries).
        2. Shards that missed an interval (last_epoch_started below the
           max) are STALE: they don't vote — their data is healed by
           recovery, their history by adoption.
        3. Among current shards the authoritative head is the MINIMUM
           last_update: an acked write committed on every live shard,
           so min >= every acked version; anything above min is an
           unacked partial write.  (reference PeeringState::calc_acting
           + the EC min-on-acting rule.)
        4. Divergent shards roll back locally; objects whose rollback
           state can't undo (deletes, overwrites pre-generations) are
           removed and reconstructed from the authoritative shards.
        5. Activate: everyone persists last_epoch_started = this epoch.
        """
        from ..crush.map import CRUSH_ITEM_NONE
        from .pg_log import (LogEntry, PGLog, entry_from_wire,
                             entry_to_wire, pg_info_t)
        be = state.backend
        acting = be.shards.acting
        live = {s: osd for s, osd in enumerate(acting)
                if osd != CRUSH_ITEM_NONE and self.osdmap.is_up(osd)}
        replies: dict[int, tuple] = {}   # shard -> (pg_info_t, [LogEntry])
        for s, osd in live.items():
            spg = spg_t(pgid, s)
            if osd == self.osd_id:
                slog = self._shard_log(spg)
                replies[s] = (slog.info, list(slog.log.entries))
            else:
                m = self._peer_rpc(osd, spg, M.MPGLogQuery)
                if m is not None:
                    replies[s] = (pg_info_t.from_json(m.info),
                                  [entry_from_wire(w) for w in m.entries])
        complete = set(replies) == set(live)
        if not complete:
            self.cct.dout("osd", 2,
                          f"peering {pgid} incomplete: shards "
                          f"{sorted(set(live) - set(replies))} did "
                          f"not answer")
            # A live shard didn't answer.  Its log may hold acked writes
            # newer than anything we heard; rolling back / activating on
            # the partial view could elect a stale shard as authority and
            # lose acknowledged data.  Do nothing destructive — the caller
            # keeps needs_peer set and refuses ops until a full round
            # succeeds (reference PeeringState only activates after a
            # complete GetInfo/GetLog round).
            return False
        max_les = max(info.last_epoch_started for info, _ in
                      replies.values())
        current = {s for s, (info, _) in replies.items()
                   if info.last_epoch_started == max_les}
        auth_head = min(replies[s][0].last_update for s in current)
        donor = max(current, key=lambda s: replies[s][0].last_update)
        auth_entries = [e for e in replies[donor][1]
                        if e.version <= auth_head]
        if any(replies[s][0].last_update > auth_head for s in replies) \
                or any(s not in current for s in replies):
            self.cct.dout("osd", 3,
                          f"peering {pgid}: auth_head={auth_head} "
                          f"current={sorted(current)} "
                          f"live={sorted(replies)}")
        # 4: divergent rollback
        removed: list[hobject_t] = []
        for s, (info, _) in replies.items():
            if info.last_update <= auth_head:
                continue
            spg = spg_t(pgid, s)
            if live[s] == self.osd_id:
                removed.extend(self._shard_log(spg).rollback_to(auth_head))
            else:
                m = self._peer_rpc(live[s], spg, M.MPGLogRollback,
                                   v=auth_head)
                if m is not None:
                    removed.extend(M.hobj_from_json(j)
                                   for j in m.removed)
        # 5: activate (stale shards adopt the authoritative log)
        les_new = self.osdmap.epoch
        wire_auth = [entry_to_wire(e) for e in auth_entries]
        for s in replies:
            spg = spg_t(pgid, s)
            adopt = s not in current
            if live[s] == self.osd_id:
                self._handle_activate(M.MPGActivate(
                    spg, 0, les_new, auth_head, wire_auth, adopt))
            else:
                self._peer_rpc(live[s], spg, M.MPGActivate, les=les_new,
                               head=auth_head, entries=wire_auth,
                               adopt=adopt)
        # seed the primary's in-memory log + version counter
        newlog = PGLog()
        for e in sorted(auth_entries, key=lambda e: e.version):
            newlog.add(e)
        newlog.head = max(newlog.head, auth_head)
        newlog.can_rollback_to = auth_head
        newlog.rollforward_to = auth_head
        be.log = newlog
        with state.lock:
            state.version = max(state.version, auth_head.version)
        # reconstruct objects whose divergent entries weren't locally
        # rollbackable (authoritative shards never applied them, so
        # decode-from-k yields the pre-divergence object)
        for oid in dict.fromkeys(removed):
            missing = [s for s in live
                       if be.shards.stat(s, oid) is None]
            if not missing:
                continue
            try:
                be.recover_shard(
                    oid, missing,
                    self._make_recovery_push(pgid, acting, oid))
            except Exception as e:  # noqa: BLE001
                self.cct.dout("osd", 1,
                              f"post-peering recovery of {oid.name} "
                              f"failed: {e!r}")
        return complete

    WRITE_OPS = {"write", "writefull", "append", "zero", "create",
                 "truncate", "delete", "setxattr", "rmxattr",
                 "call", "notify", "watch", "unwatch",
                 "omapsetkeys", "omaprmkeys", "omapclear",
                 "omapsetheader"}

    @staticmethod
    def _caps_can_write(caps: str) -> bool:
        """'allow *' or any allow grant containing w ('allow w',
        'allow rw', 'allow rwx' — the OSDCap spellings the keyring
        writes)."""
        import re
        return "allow *" in caps or \
            re.search(r"allow\s+[rx]*w", caps) is not None

    def _reply_op_error(self, conn, msg: M.MOSDOp, e: BaseException
                        ) -> None:
        """Map an op-path exception to an errno reply: ValueError
        (malformed/hostile client payload) becomes EINVAL.  Log only
        the unexpected — EAGAIN is routine peering backoff, and a
        ValueError is already answered, so neither deserves a
        traceback a hostile client could spam."""
        eno = getattr(e, "errno", None) or \
            (errno.EINVAL if isinstance(e, ValueError) else errno.EIO)
        if eno != errno.EAGAIN and not isinstance(e, ValueError):
            import traceback
            traceback.print_exc()
        top = getattr(msg, "top", None)
        if top is not None:
            top.mark_event("failed")
            self.op_tracker.unregister(top, -eno)
        try:
            conn.send_message(M.MOSDOpReply(msg.tid, -eno))
        except Exception:   # connection already gone
            pass

    def _handle_client_op_safe(self, conn, msg: M.MOSDOp) -> None:
        """Exception fence for ops that run off the dispatch thread
        (op pool / notify thread).  Without it a raised error — incl.
        the routine EAGAIN from _get_pg during peering — dies inside
        the Future and the client stalls a full attempt timeout
        instead of fast-retrying (reference: do_op replies -errno on
        every failure path)."""
        top = getattr(msg, "top", NULL_TRACKED)
        top.mark_event("dequeued")
        try:
            with self._on_device():
                self._handle_client_op(conn, msg)
        except Exception as e:  # noqa: BLE001 - must reply, not die
            self._reply_op_error(conn, msg, e)
        finally:
            # idempotent: the write/read paths unregister with their
            # result; this net catches early-return paths (snap
            # reads, watch control ops, caps/blacklist rejections)
            self.op_tracker.unregister(top)

    def _handle_client_op(self, conn, msg: M.MOSDOp) -> None:
        """reference PrimaryLogPG::do_op/do_osd_ops: decode the op
        vector, build a PGTransaction for mutations, execute reads."""
        # blacklist fence (reference OSDMap blacklist / EBLACKLISTED):
        # a fenced client's ops — including ones already in flight
        # when an exclusive-lock steal blacklisted it — are rejected,
        # never applied
        ent = getattr(conn, "peer_entity", None)
        if ent is not None and \
                self.osdmap.blacklist.get(ent, 0) > time.time():
            # expired entries no longer fence (the mon prunes them
            # from the map lazily; the TTL is authoritative here)
            conn.send_message(M.MOSDOpReply(
                msg.tid, -errno.ESHUTDOWN, b"", self.osdmap.epoch))
            return
        # OSDCap check: a read-only client credential cannot mutate
        # (reference OSDCap grammar reduced to the keyring's subset)
        if self.messenger.auth is not None:
            ident = getattr(conn.session, "auth_identity", None) or {}
            caps = ident.get("caps", "")
            if ident.get("kind") in ("ticket", "client_key") and \
                    not self._caps_can_write(caps) and \
                    any(op[0] in self.WRITE_OPS for op in msg.ops):
                conn.send_message(M.MOSDOpReply(
                    msg.tid, -errno.EACCES, b"", self.osdmap.epoch))
                return
        self.perf.inc("op")
        _t0 = time.perf_counter()
        # Per-object op ordering (reference PrimaryLogPG do_op obc
        # ordering): ALL ops on one object serialize — cls calls are
        # read-modify-write and must not interleave with each other OR
        # with plain writes.  Striped locks keep the table bounded.
        # Watch/notify control ops stay lock-free: notify blocks on
        # watcher acks, and a watcher that touches the object in its
        # handler would deadlock against the stripe (the reference
        # drops the obc lock around the ack wait too).
        if {op[0] for op in msg.ops} <= {"watch", "unwatch", "notify"}:
            if any(op[0] == "notify" for op in msg.ops):
                # notify blocks on watcher acks; a watcher sharing the
                # notifier's connection would ack on the very reader
                # thread this handler is occupying — run async
                # (reference: notifies complete via a Context, not
                # inline in the dispatch thread)
                threading.Thread(
                    target=self._do_client_op_safe, args=(conn, msg, _t0),
                    daemon=True,
                    name=f"osd.{self.osd_id}.notify").start()
            else:
                self._do_client_op(conn, msg, _t0)
            return
        key = (msg.pgid.pgid.pool, msg.oid.name)
        with self._obj_locks[hash(key) % len(self._obj_locks)]:
            self._do_client_op(conn, msg, _t0)

    def _do_client_op_safe(self, conn, msg: M.MOSDOp, _t0: float) -> None:
        """Same exception fence as _handle_client_op_safe for the
        detached notify thread."""
        try:
            self._do_client_op(conn, msg, _t0)
        except Exception as e:  # noqa: BLE001
            self._reply_op_error(conn, msg, e)

    def _do_client_op(self, conn, msg: M.MOSDOp, _t0: float) -> None:
        # PG-split retarget (reference OSD::handle_op split requeue):
        # under THIS osd's map the object may hash into a child of the
        # PG the client computed.  If we lead the child, the op simply
        # requeues against it; otherwise _get_pg raises EAGAIN and the
        # client retargets off its refreshed map.
        top = getattr(msg, "top", NULL_TRACKED)
        pool = self.osdmap.pools.get(msg.pgid.pgid.pool)
        if pool is not None and pool.pg_num:
            actual = self.osdmap.object_to_pg(pool.id, msg.oid.name,
                                              msg.oid.key)
            if actual != msg.pgid.pgid:
                msg.pgid = spg_t(actual, msg.pgid.shard)
                top.set_info("pg", str(msg.pgid.pgid))
        state = self._get_pg(msg.pgid.pgid)
        be = state.backend
        if msg.oid.snap != 0:
            self._do_snap_read(conn, msg, state)
            return
        txn = PGTransaction()
        data_off = 0
        read_payload = b""
        result = 0
        out_meta: list = []
        # op-vector OVERLAY: later ops in one compound message must see
        # the staged effects of earlier ones (reference do_osd_ops runs
        # the vector against the evolving object state).  vsize/vexists
        # None = not yet consulted; vattrs holds staged xattr values
        # (None = staged removal).
        vsize: int | None = None
        vexists: bool | None = None
        vattrs: dict[str, bytes | None] = {}
        vtrunc: int | None = None        # staged truncate_to (the txn
        # holds ONE truncate value applied after writes, so an op that
        # extends past it must raise it or be clipped)
        vbase_dropped = False            # a delete ran in this vector:
        # the committed object state (size, xattrs) is gone for good,
        # even if a later op recreates the object — consult only the
        # staged views from then on

        def cur_exists() -> bool:
            nonlocal vexists
            if vexists is None:
                vexists = self._object_exists(state, msg.oid)
            return vexists

        def cur_size():
            nonlocal vsize, vexists
            if vexists is False:
                # known absent (a staged delete/earlier miss), which is
                # DISTINCT from vsize None = "not yet consulted": the op
                # vector must see the evolving state, not re-read the
                # committed pre-delete object (reference do_osd_ops runs
                # later ops against the mutated obs)
                return None
            if vsize is None:
                if vbase_dropped:
                    return None  # recreated post-delete but size never
                    # staged: committed state is dead, nothing to read
                vsize = self._stat_logical(state, msg.oid)
                vexists = vsize is not None
            return vsize

        def cur_xattr(key: str):
            if key in vattrs:
                return vattrs[key]
            if vexists is False or vbase_dropped:
                # known absent OR recreated after an in-vector delete:
                # the committed xattrs died with the delete — a
                # fall-through read would resurrect pre-delete values
                return None
            from ..cls import ClsContext
            ctx = ClsContext(self, state, msg.pgid.pgid, msg.oid)
            return ctx.getxattr(key)

        for op in msg.ops:
            name = op[0]
            if name == "write":
                _, off, ln = op
                txn.write(msg.oid, off,
                          np.frombuffer(msg.data[data_off:data_off + ln],
                                        dtype=np.uint8))
                data_off += ln
                vsize = max(cur_size() or 0, off + ln)
                vexists = True
                if vtrunc is not None and off + ln > vtrunc:
                    txn.truncate(msg.oid, off + ln)
                    vtrunc = off + ln
            elif name == "writefull":
                _, ln = op
                txn.write(msg.oid, 0,
                          np.frombuffer(msg.data[data_off:data_off + ln],
                                        dtype=np.uint8))
                txn.truncate(msg.oid, ln)  # clip any previous tail
                data_off += ln
                vsize, vexists, vtrunc = ln, True, ln
            elif name == "truncate":
                txn.truncate(msg.oid, op[1])
                vsize = vtrunc = op[1]
            elif name == "append":
                # reference CEPH_OSD_OP_APPEND: write at current size
                _, ln = op
                size = cur_size() or 0
                txn.write(msg.oid, size,
                          np.frombuffer(msg.data[data_off:data_off + ln],
                                        dtype=np.uint8))
                data_off += ln
                vsize, vexists = size + ln, True
                if vtrunc is not None and size + ln > vtrunc:
                    txn.truncate(msg.oid, size + ln)
                    vtrunc = size + ln
            elif name == "zero":
                # reference CEPH_OSD_OP_ZERO: logical zeros, no size
                # change; on a nonexistent object it is a successful
                # no-op (PrimaryLogPG ZERO: !obs.exists -> result 0)
                _, off, ln = op
                size = cur_size()
                if size is not None and off < size:
                    txn.write(msg.oid, off,
                              np.zeros(min(ln, size - off),
                                       dtype=np.uint8))
            elif name == "create":
                # reference CEPH_OSD_OP_CREATE: op[1] truthy = excl
                if cur_exists():
                    if len(op) > 1 and op[1]:
                        result = -errno.EEXIST
                        break
                else:
                    txn.write(msg.oid, 0,
                              np.zeros(0, dtype=np.uint8))
                    vsize, vexists = 0, True
            elif name == "delete":
                txn.delete(msg.oid)
                vsize, vexists, vattrs = None, False, {}
                vbase_dropped = True
            elif name == "rmxattr":
                # reference: rmxattr on a nonexistent object is ENOENT
                # (it must not materialize a phantom object)
                if not cur_exists():
                    result = -errno.ENOENT
                    break
                txn.setattr(msg.oid, op[1], None)
                vattrs[op[1]] = None
            elif name == "getxattr":
                val = cur_xattr(op[1])
                if val is None:
                    result = -errno.ENODATA
                    break
                read_payload += bytes(val)
            elif name == "cmpxattr":
                # reference CEPH_OSD_OP_CMPXATTR (EQ): guard ops on an
                # xattr's current value; mismatch cancels the op
                _, key, ln = op
                want = bytes(msg.data[data_off:data_off + ln])
                data_off += ln
                have = cur_xattr(key)
                if have is None or bytes(have) != want:
                    result = -errno.ECANCELED
                    break
            elif name == "setxattr":
                _, key, ln = op
                val = bytes(msg.data[data_off:data_off + ln])
                txn.setattr(msg.oid, key, val)
                vattrs[key] = val
                data_off += ln
            elif name == "read":
                _, off, ln = op
                # existence through the staged view: a read after an
                # in-message delete is ENOENT even though the committed
                # object still exists until the txn applies
                if not cur_exists():
                    result = -errno.ENOENT
                    break
                if vbase_dropped:
                    # the committed bytes died with the in-vector
                    # delete: serve the staged recreate only (zeros
                    # base + this message's writes), never the
                    # pre-delete store content
                    size = cur_size() or 0
                    end = size if ln <= 0 else min(off + ln, size)
                    buf = np.zeros(max(end - off, 0), dtype=np.uint8)
                    objop = txn.ops.get(msg.oid)
                    for w in (objop.writes if objop else []):
                        lo, hi = max(off, w.offset), min(end, w.end)
                        if lo < hi:
                            buf[lo - off:hi - off] = \
                                w.data[lo - w.offset:hi - w.offset]
                    read_payload += buf.tobytes()
                else:
                    data = be.read(msg.oid, off, ln if ln > 0 else None)
                    read_payload += data.tobytes() \
                        if data is not None else b""
            elif name == "stat":
                size = cur_size()
                if size is None:
                    result = -errno.ENOENT
                else:
                    out_meta.append(["stat", size])
            elif name == "call":
                # server-side compute (reference CEPH_OSD_OP_CALL ->
                # ClassHandler dispatch, PrimaryLogPG.cc:5643)
                from .. import cls as cls_mod
                _, spec, inlen = op
                inp = bytes(msg.data[data_off:data_off + inlen])
                data_off += inlen
                cls_name, _, method = spec.partition(".")
                fn = cls_mod.get_method(cls_name, method)
                if fn is None:
                    result = -errno.EOPNOTSUPP
                    break
                ctx = cls_mod.ClsContext(self, state, msg.pgid.pgid,
                                         msg.oid)
                try:
                    read_payload += fn(ctx, inp)
                except cls_mod.ClsError as e:
                    result = -e.errno
                    break
                if ctx._pending_write is not None:
                    off_w, data_w = ctx._pending_write
                    txn.write(msg.oid, off_w,
                              np.frombuffer(data_w, dtype=np.uint8))
                    txn.truncate(msg.oid, off_w + len(data_w))
                for k, v in ctx._pending_attrs.items():
                    txn.setattr(msg.oid, k, v)
            elif name.startswith("omap"):
                # reference PrimaryLogPG.cc:5643 OMAP op cases; omap is
                # replicated-pool-only (EC pools lack omap support in
                # the reference too: pool SUPPORTS_OMAP flag)
                if state.kind == "ec":
                    result = -errno.EOPNOTSUPP
                    break
                from ..common import omap_codec as oc
                cid = self._cid(spg_t(msg.pgid.pgid, NO_SHARD))
                goid = ghobject_t(msg.oid, shard=NO_SHARD)
                if name == "omapsetkeys":
                    _, ln = op
                    kv, _end = oc.decode_kv(msg.data[data_off:
                                                     data_off + ln])
                    data_off += ln
                    txn.omap_setkeys(msg.oid, kv)
                elif name == "omaprmkeys":
                    _, ln = op
                    keys, _end = oc.decode_keys(msg.data[data_off:
                                                         data_off + ln])
                    data_off += ln
                    txn.omap_rmkeys(msg.oid, keys)
                elif name == "omapclear":
                    txn.omap_clear(msg.oid)
                elif name == "omapsetheader":
                    _, ln = op
                    txn.omap_setheader(
                        msg.oid, bytes(msg.data[data_off:data_off + ln]))
                    data_off += ln
                elif name in ("omapgetkeys", "omapgetvals"):
                    _, saln, maxret = op
                    (starts, _e) = oc.decode_keys(
                        msg.data[data_off:data_off + saln])
                    data_off += saln
                    start_after = starts[0] if starts else None
                    if not self._object_exists(state, msg.oid):
                        result = -errno.ENOENT
                        break
                    omap = self.store.omap_get(cid, goid)
                    ks = sorted(k for k in omap
                                if start_after is None or k > start_after)
                    if maxret > 0:
                        ks = ks[:maxret]
                    if name == "omapgetkeys":
                        read_payload += oc.encode_keys(ks)
                    else:
                        read_payload += oc.encode_kv(
                            {k: omap[k] for k in ks})
                elif name == "omapgetvalsbykeys":
                    _, ln = op
                    keys, _e = oc.decode_keys(
                        msg.data[data_off:data_off + ln])
                    data_off += ln
                    if not self._object_exists(state, msg.oid):
                        result = -errno.ENOENT
                        break
                    omap = self.store.omap_get(cid, goid)
                    read_payload += oc.encode_kv(
                        {k: omap[k] for k in keys if k in omap})
                elif name == "omapgetheader":
                    if not self._object_exists(state, msg.oid):
                        result = -errno.ENOENT
                        break
                    read_payload += self.store.omap_get_header(cid, goid)
                else:
                    result = -errno.EOPNOTSUPP
                    break
            elif name == "listwatchers":
                # reference CEPH_OSD_OP_LIST_WATCHERS (librados
                # rados_watchers_list).  Disconnected watchers are
                # FILTERED from the reply (a crashed lock owner must
                # not look alive) but stay registered — a lossless
                # session mid-reconnect gets its frames replayed on
                # resume, and deregistering it here would break that
                # delivery guarantee.
                import json as _json
                key = (msg.pgid.pgid.pool, msg.oid.name)
                with self.pg_lock:
                    live = sorted(
                        ck for ck, c in
                        self.watchers.get(key, {}).items()
                        if c.is_connected())
                read_payload += _json.dumps(live).encode()
            elif name == "watch":
                _, cookie = op
                key = (msg.pgid.pgid.pool, msg.oid.name)
                with self.pg_lock:
                    self.watchers.setdefault(key, {})[cookie] = conn
            elif name == "unwatch":
                _, cookie = op
                key = (msg.pgid.pgid.pool, msg.oid.name)
                with self.pg_lock:
                    self.watchers.get(key, {}).pop(cookie, None)
            elif name == "notify":
                _, ln = op
                payload = bytes(msg.data[data_off:data_off + ln])
                data_off += ln
                self._do_notify(msg.pgid.pgid, msg.oid, payload)
            else:
                result = -errno.EOPNOTSUPP
        if result == 0 and txn.ops and \
                self._live_shards(state) < self._pool_min_size(msg.pgid.pgid):
            # Below min_size an acked write could land on fewer than k
            # shards and be unrecoverable; block it (reference
            # PrimaryLogPG/PeeringState min_size enforcement).
            result = -errno.EAGAIN
        elif result == 0 and txn.ops:
            self.perf.inc("op_w")
            if self.pg_ledger.enabled:
                # >= min_size but < size: the write will ack while
                # some shard has no live home — the degraded-window
                # ledger counts exactly these acks (docs/TRACING.md
                # "Control plane")
                _pool = self.osdmap.pools.get(msg.pgid.pgid.pool)
                if _pool is not None and \
                        self._live_shards(state) < _pool.size:
                    self.pg_ledger.degraded_ack(msg.pgid.pgid)
            if msg.snapc and int(msg.snapc[0]) > 0:
                # copy-on-write before the mutation lands (reference
                # PrimaryLogPG::make_writeable)
                for woid, objop in list(txn.ops.items()):
                    self._maybe_cow(state, msg.pgid.pgid, woid,
                                    int(msg.snapc[0]),
                                    is_delete=objop.delete)
            done = threading.Event()
            window = float(self.cct.conf.get("tpu_batch_window_ms")
                           or 0)
            # version allocation and pipeline entry must be ATOMIC:
            # with ops running concurrently (sharded op pool), a later
            # version entering the FIFO pipeline first would commit out
            # of order and violate the PG log's monotonicity.  The
            # blocking metadata prefetch runs BEFORE the lock.
            staged = be.make_op(txn, done.set, top=top) \
                if state.kind == "ec" else None
            if window > 0 and state.kind == "ec":
                # dynamic batch window (SURVEY section 7 "hard parts",
                # BlueStore-deferred style): hold the pipeline drain
                # briefly so concurrent client ops encode in ONE codec
                # launch instead of one launch each.  Armed AFTER the
                # prefetch: the window must cover enqueue, not the
                # metadata RPCs.
                self._arm_batch_drain(be, window)
            with state.lock:
                version = state.next_version(self.osdmap.epoch)
                top.set_info("version", str(version))
                if staged is not None:
                    be.enqueue(staged, version)
                else:
                    be.submit_transaction(txn, version, done.set)
            if not done.wait(30):
                result = -errno.ETIMEDOUT
                top.mark_event("timeout")
            elif staged is not None and staged.error is not None:
                # pipeline failure containment acks with the error
                # attached instead of raising (docs/PIPELINE.md) — the
                # client must NOT see a failed write as durable
                result = -errno.EIO
            elif staged is None:
                # EC ops mark commit/failed inside the pipeline's
                # in-order finisher; replicated ops commit here
                top.mark_event("commit")
        elif result == 0:
            self.perf.inc("op_r")
        self.perf.tinc("op_latency", time.perf_counter() - _t0)
        top.mark_event("reply_sent")
        conn.send_message(M.MOSDOpReply(msg.tid, result, read_payload,
                                        self.osdmap.epoch))
        self.op_tracker.unregister(top, result)

    def _arm_batch_drain(self, be, window_ms: float) -> None:
        """One timer per backend per window: the first op entering an
        idle window holds the drain and schedules the release; ops
        arriving meanwhile pile into waiting_reads and flush together."""
        with self.pg_lock:
            armed = self._batch_armed.get(id(be))
            if armed:
                return
            self._batch_armed[id(be)] = True
        with be.lock:
            be._hold += 1

        def _release():
            with self.pg_lock:
                self._batch_armed[id(be)] = False
            # check_ops must run UNDER be.lock (the batch() context
            # manager's form): an unlocked drain races a concurrent
            # locked check_ops and double-plans the head op
            with self._on_device(), be.lock:
                be._hold -= 1
                if be._hold == 0:
                    be.check_ops()

        t = threading.Timer(window_ms / 1000.0, _release)
        t.daemon = True
        t.start()

    # -- self-managed snapshots (reference SnapSet + make_writeable) --------

    def _head_snapset(self, state: PGState, pgid: pg_t,
                      head: hobject_t):
        from .snapset import SS_KEY, SnapSet
        be = state.backend
        if state.kind == "ec":
            for s in range(be.n):
                attrs = be.shards.get_attrs(s, head)
                if attrs is not None:
                    return SnapSet.decode(attrs.get(SS_KEY)), True
            return SnapSet(), False
        # replicated: the primary holds a full local copy
        goid = ghobject_t(head, shard=NO_SHARD)
        cid = self._cid(spg_t(pgid, NO_SHARD))
        try:
            attrs = self.store.getattrs(cid, goid)
        except KeyError:
            return SnapSet(), False
        return SnapSet.decode(attrs.get(SS_KEY)), True

    def _maybe_cow(self, state: PGState, pgid: pg_t, oid: hobject_t,
                   seq: int, is_delete: bool = False) -> None:
        """Clone the head to <oid, snap=seq> when the op's SnapContext
        is newer than what the head has seen.  A delete additionally
        parks the SnapSet on the snapdir object so a later recreate
        keeps the clone history (reference CEPH_SNAPDIR)."""
        from dataclasses import replace
        from .snapset import SNAPDIR, SS_KEY, SnapSet
        be = state.backend
        head = replace(oid, snap=0)
        snapdir = replace(oid, snap=SNAPDIR)
        if not is_delete and state.snap_seqs.get(head, -1) >= seq:
            return   # head already saw this snapc: no fetch, no COW
        ss, exists = self._head_snapset(state, pgid, head)
        if not exists:
            # (re)born under this snapc: snaps <= seq predate this
            # incarnation, but a snapdir left by a deleted predecessor
            # carries clone history that must survive
            prior, had_dir = self._head_snapset(state, pgid, snapdir)
            ss = SnapSet(seq=seq, clones=prior.clones if had_dir else [],
                         born=seq,
                         prior_born=prior.born if had_dir else 0)
            self._bcast_head_txn(state, pgid, head, None, ss)
            state.snap_seqs[head] = seq
            return
        if ss.needs_cow(seq):
            ss.add_clone(seq)
            self._bcast_head_txn(state, pgid, head,
                                 replace(head, snap=seq), ss)
        state.snap_seqs[head] = max(ss.seq, seq)
        if is_delete:
            # park the SnapSet for the next incarnation
            self._bcast_head_txn(state, pgid, snapdir, None, ss)
            state.snap_seqs.pop(head, None)

    def _bcast_head_txn(self, state: PGState, pgid: pg_t,
                        head: hobject_t, clone_to: hobject_t | None,
                        ss, timeout: float = 15.0) -> None:
        """Send clone+snapset (or snapset-only) transactions to every
        shard/replica and WAIT for the commits: a silently-failed clone
        would lose snapshot history while the triggering write goes on
        to succeed.  Session FIFO additionally orders these before the
        write that triggered the COW."""
        from .snapset import SS_KEY
        be = state.backend
        pending = {"n": 0}
        plock = threading.Lock()
        done = threading.Event()

        def on_commit(_sr) -> None:
            with plock:          # replies race on reader threads
                pending["n"] -= 1
                if pending["n"] <= 0:
                    done.set()

        if state.kind == "ec":
            pending["n"] = be.n
            for s in range(be.n):
                txn = Transaction()
                if clone_to is not None:
                    txn.clone(shard_oid(head, s), shard_oid(clone_to, s))
                txn.setattr(shard_oid(head, s), SS_KEY, ss.encode())
                be.shards.sub_write(s, txn, on_commit)
        else:
            pending["n"] = be.replicas.n_replicas
            for r in range(be.replicas.n_replicas):
                txn = Transaction()
                hg = ghobject_t(head, shard=NO_SHARD)
                if clone_to is not None:
                    txn.clone(hg, ghobject_t(clone_to, shard=NO_SHARD))
                txn.setattr(hg, SS_KEY, ss.encode())
                be.replicas.rep_write(r, txn, on_commit)
        if not done.wait(timeout):
            raise ErasureCodeError(
                errno.EAGAIN,
                f"snapshot COW of {head.name} did not commit everywhere")

    def _do_snap_read(self, conn, msg: M.MOSDOp, state: PGState) -> None:
        """Serve read/stat at a snap id by resolving the SnapSet to the
        covering clone (reference PrimaryLogPG::find_object_context
        with a snapid)."""
        from dataclasses import replace
        from .snapset import SNAPDIR
        be = state.backend
        head = replace(msg.oid, snap=0)
        ss, exists = self._head_snapset(state, msg.pgid.pgid, head)
        if not exists:
            # deleted head: its clone history lives on the snapdir
            ss, exists = self._head_snapset(
                state, msg.pgid.pgid, replace(msg.oid, snap=SNAPDIR))
        target_snap = ss.resolve(msg.oid.snap) if exists else None
        if target_snap == 0 and not self._object_exists(state, head):
            target_snap = None      # resolved to a deleted head
        if target_snap is None:
            conn.send_message(M.MOSDOpReply(
                msg.tid, -errno.ENOENT, b"", self.osdmap.epoch))
            return
        roid = head if target_snap == 0 else \
            replace(msg.oid, snap=target_snap)
        read_payload = b""
        result = 0
        for op in msg.ops:
            name = op[0]
            if name == "read":
                _, off, ln = op
                try:
                    data = be.read(roid, off, ln if ln > 0 else None)
                    read_payload += data.tobytes() \
                        if data is not None else b""
                except ErasureCodeError as e:
                    result = -e.errno
                    break
            elif name == "stat":
                pass
            else:
                result = -errno.EROFS   # snapshots are read-only
                break
        conn.send_message(M.MOSDOpReply(msg.tid, result, read_payload,
                                        self.osdmap.epoch))

    def _pool_min_size(self, pgid: pg_t) -> int:
        pool = self.osdmap.pools.get(pgid.pool)
        return pool.min_size if pool is not None else 1

    def _live_shards(self, state: PGState) -> int:
        """Count acting-set members that are placed and up."""
        from ..crush.map import CRUSH_ITEM_NONE
        be = state.backend
        tgt = be.shards if state.kind == "ec" else be.replicas
        return sum(1 for o in tgt.acting
                   if o != CRUSH_ITEM_NONE and self.osdmap.is_up(o))

    def _object_exists(self, state: PGState, oid: hobject_t) -> bool:
        be = state.backend
        if state.kind == "ec":
            return be.exists(oid)
        return be.stat(oid) is not None

    def _stat_logical(self, state: PGState, oid: hobject_t) -> int | None:
        be = state.backend
        if state.kind == "ec":
            size = be._get_size(oid)
            return size if size > 0 else (
                None if be.shards.stat(0, oid) is None else size)
        return be.stat(oid)

    # -- watch/notify (reference osd/Watch.h, PrimaryLogPG notify) ----------

    def _do_notify(self, pgid: pg_t, oid: hobject_t,
                   payload: bytes, timeout: float = 5.0) -> None:
        key = (pgid.pool, oid.name)
        with self.pg_lock:
            # skip (but keep registered) disconnected watchers: waiting
            # the full ack timeout on a dead connection stalls every
            # notify, but a lossless session mid-reconnect must keep
            # its registration for replay delivery
            targets = {ck: c for ck, c in
                       self.watchers.get(key, {}).items()
                       if c.is_connected()}
            self._notify_id += 1
            nid = self._notify_id
        if not targets:
            return
        ev = threading.Event()
        self._notify_pending[nid] = {
            "remaining": set(targets), "event": ev}
        for cookie, conn in targets.items():
            try:
                conn.send_message(M.MWatchNotify(oid, nid, cookie,
                                                 payload))
            except Exception:  # noqa: BLE001 - dead watcher
                self._notify_pending[nid]["remaining"].discard(cookie)
        ev.wait(timeout)
        self._notify_pending.pop(nid, None)

    # -- scrub (asok-driven AND background-scheduled; reference
    #    `ceph pg scrub` + PG::sched_scrub) ---------------------------------

    def _scrub_led_pgs(self, deep: bool, repair: bool) -> dict:
        """Scrub every EC PG this OSD currently leads."""
        from . import scrub as scrub_mod
        out = {}
        for pool in list(self.osdmap.pools.values()):
            if not pool.is_erasure():
                # replicated pools: no EC scrub, but snap trim applies
                for seed in range(pool.pg_num):
                    pgid = pg_t(pool.id, seed)
                    _, acting, _, primary = \
                        self.osdmap.pg_to_up_acting_osds(pgid)
                    if primary != self.osd_id:
                        continue
                    try:
                        state = self._get_pg(pgid)
                    except ErasureCodeError:
                        continue   # unpeered PG: skip this round
                    names = self._pg_object_names(pgid, acting, [0])
                    trimmed = self._trim_snaps(state, pgid, names)
                    if trimmed:
                        out[str(pgid)] = {"objects": len(names),
                                          "errors": [], "repaired": 0,
                                          "snaps_trimmed": trimmed}
                continue
            for seed in range(pool.pg_num):
                pgid = pg_t(pool.id, seed)
                _, acting, _, primary = \
                    self.osdmap.pg_to_up_acting_osds(pgid)
                if primary != self.osd_id:
                    continue
                try:
                    state = self._get_pg(pgid)
                except ErasureCodeError:
                    continue   # unpeered PG: scrub it next round
                names = sorted(self._pg_object_names(
                    pgid, acting, range(state.backend.n)),
                    key=lambda o: o.name)
                use_device = None  # platform default
                if not bool(self.cct.conf.get("osd_deep_scrub_device")):
                    use_device = False
                with self._on_device():
                    res = scrub_mod.scrub_pg(state.backend, names,
                                             deep=deep, repair=repair,
                                             use_device=use_device)
                trimmed = self._trim_snaps(state, pgid, names)
                out[str(pgid)] = {
                    "objects": res.objects,
                    "errors": [[e.oid.name, e.shard, e.kind, e.detail]
                               for e in res.errors],
                    "repaired": len(res.repaired),
                    "snaps_trimmed": trimmed,
                    "device_bytes": res.device_bytes,
                    "host_bytes": res.host_bytes,
                }
        return out

    def _asok_scrub(self, cmd: dict) -> dict:
        # scrub runs are tracked ops too (reference: scrubs surface in
        # dump_ops_in_flight / slow-op checks like client ops)
        top = self.op_tracker.create(
            "scrub", f"deep={bool(cmd.get('deep', True))}")
        top.mark_event("scrub_start")
        try:
            out = self._scrub_led_pgs(
                deep=bool(cmd.get("deep", True)),
                repair=bool(cmd.get("repair", False)))
        except Exception:
            top.mark_event("failed")
            self.op_tracker.unregister(top, -errno.EIO)
            raise
        top.mark_event("scrub_done")
        self.op_tracker.unregister(top, 0)
        return out

    # -- multichip mesh plane (docs/MULTICHIP.md) ---------------------------

    def _mesh_service(self):
        """The per-host MeshService when osd_ec_use_mesh is on; None
        otherwise (EC backends then run the single-chip plane).
        Configuration failures (not enough devices, bad shape) are
        logged config errors, never daemon-fatal."""
        if not bool(self.cct.conf.get("osd_ec_use_mesh")):
            return None
        from ..parallel.service import MeshService
        try:
            return MeshService.get_or_configure(
                str(self.cct.conf.get("mesh_devices")))
        except Exception as e:  # noqa: BLE001 — MeshError et al.
            self.cct.dout("osd", 1,
                          f"mesh service unavailable ({e}); EC PGs "
                          f"will use the single-chip plane")
            return None

    def _with_device(self, prof) -> dict:
        """An EC profile as this daemon's codecs take it: a `torch`
        profile that names no device runs on the daemon's; one that
        names a device keeps it."""
        prof = dict(prof)
        if prof.get("plugin") == "torch" and not prof.get("device"):
            prof["device"] = self.device
        return prof

    def _host_launch_queue(self):
        """The per-host EC launch queue (cross-PG continuous batching,
        parallel/launch_queue.py) when osd_ec_host_batch is on; None
        otherwise (each PG then launches its own drains).  Handed out
        through the MeshService seam — it brokers the device plane, so
        it brokers the launch queue — and works with or without a
        configured mesh.  The queue's perf counters (launches,
        coalescing, occupancy, lat_ec_batch_wait) register into
        exactly ONE daemon's collection per host (the first to wire
        the queue) so `perf dump` / `dump_latencies` / the prometheus
        exporter surface them ONCE: the set is host-level, and every
        daemon re-exporting the shared singleton would make the
        normal sum-across-daemons aggregation read n_daemons times
        the real launch/byte counts.  Every daemon still serves the
        host truth via the `launch queue status` asok."""
        if not bool(self.cct.conf.get("osd_ec_host_batch")):
            return None
        from ..parallel.service import MeshService
        queue = MeshService.host_launch_queue(
            window_us=float(self.cct.conf.get(
                "osd_ec_host_batch_window_us")),
            max_bytes=int(self.cct.conf.get(
                "osd_ec_host_batch_max_bytes")),
            device=self.device)
        if not getattr(queue, "_perf_registered", False):
            queue._perf_registered = True
            self.cct.perf.add(queue.perf)
        return queue

    def _asok_launch_queue_status(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok launch queue status`: the host
        queue's batching knobs + launch/coalescing/occupancy
        aggregates, plus this OSD's per-PG routed-drain counts — an
        operator reads occupancy % and runs-per-launch here to see
        whether PG fan-out is actually coalescing."""
        from ..parallel.launch_queue import ECLaunchQueue
        queue = ECLaunchQueue.host_get()
        with self.pg_lock:
            pgs = {
                str(pgid): st.backend.perf.dump().get(
                    "ec_host_queue_drains", 0)
                for pgid, st in self.pgs.items() if st.kind == "ec"}
        return {
            "osd": self.osd_id,
            "enabled": bool(self.cct.conf.get("osd_ec_host_batch")),
            "queue": queue.status() if queue is not None else None,
            "pg_queue_drains": pgs,
        }

    def _asok_repair_status(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok repair status` (docs/REPAIR.md):
        recovery backlog + throttle knobs + the scheduler's recovery-
        class serve counts, and each led EC PG's repair ledger
        (helper-bytes-read vs reconstructed-bytes — the CLAY savings —
        plus reconstruct-on-read / read-timeout provenance)."""
        from ..parallel.launch_queue import ECLaunchQueue
        with self.pg_lock:
            pgs = {str(pgid): st.backend.repair_status()
                   for pgid, st in self.pgs.items()
                   if st.kind == "ec"}
            needing = sorted(str(p)
                             for p in self._pgs_needing_recovery)
            inflight = self._recovery_inflight
            unfound = {str(p): len(objs)
                       for p, objs in self._unfound.items()}
        sched = None
        if self.op_wq is not None:
            sched = self.op_wq.dump().get("classes", {}).get("recovery")
        perf = self.perf.dump()
        queue = ECLaunchQueue.host_get()
        qst = queue.status() if queue is not None else {}
        return {
            "osd": self.osd_id,
            "recovery": {
                "inflight_passes": inflight,
                "pgs_needing_recovery": needing,
                "unfound": unfound,
                "queued_ops": perf.get("recovery_queued_ops", 0),
                "pushed_bytes": perf.get("recovery_pushed_bytes", 0),
                "throttle": {
                    "max_bytes_per_sec": int(self.cct.conf.get(
                        "osd_recovery_max_bytes_per_sec") or 0),
                    "sleep_s": float(self.cct.conf.get(
                        "osd_recovery_sleep") or 0.0),
                    "wait": perf.get("recovery_throttle_wait"),
                },
            },
            "scheduler_recovery_class": sched,
            "host_queue": {
                "decode_launches": qst.get("decode_launches", 0),
                "repair_launches": qst.get("repair_launches", 0),
            },
            "stuck_subwrites": self._stuck_subwrites(),
            "pgs": pgs,
        }

    def _stuck_subwrites(self, mark: bool = False) -> list[dict]:
        """EC client writes whose shard sub-writes have been in
        flight past osd_stuck_subwrite_s (a known reduction: an op
        wedged across a SIGKILL re-peer used to stall
        active+clean waits with no trace).  Surfaces each as
        stuck_subwrite(pg) in `repair status`; with mark=True the
        event is stamped on the op's timeline ONCE so slow-op blame
        names it instead of a bare 'waiting after sub_write_sent'."""
        raw = self.cct.conf.get("osd_stuck_subwrite_s")
        thresh = 10.0 if raw is None else float(raw)
        if thresh <= 0:
            return []
        now = time.time()
        out: list[dict] = []
        with self.pg_lock:
            ec_pgs = [(pgid, st.backend)
                      for pgid, st in self.pgs.items()
                      if st.kind == "ec"]
        for pgid, be in ec_pgs:
            with be.lock:
                waiting = list(be.waiting_commit)
            for op in waiting:
                if op.state != "committing" or \
                        op.pending_commits <= 0:
                    continue
                top = op.top
                age = (now - top.initiated_at) \
                    if getattr(top, "is_tracked", False) else None
                if age is None or age < thresh:
                    continue
                blame = f"stuck_subwrite({pgid})"
                if mark and not any(n == blame
                                    for _, n in top.events):
                    top.mark_event(blame)
                out.append({
                    "pg": str(pgid),
                    "blame": blame,
                    "age_s": round(age, 3),
                    "pending_shards": op.pending_commits,
                    "version": str(op.version),
                    "trace_id": top.trace.trace_id
                    if top.trace is not None else None,
                })
        return out

    def _asok_pg_ledger(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok pg ledger` (docs/TRACING.md
        "Control plane"): the per-PG state-machine ledger — current
        state + bounded transition ring per PG, peering/recovery
        stage decomposition, O(peers) scan counters, degraded
        windows, and the lat_peering_*/lat_recovery_* percentile
        summaries."""
        out = self.pg_ledger.dump(
            last=int(cmd["last"]) if "last" in cmd else 8)
        out["osd"] = self.osd_id
        out["pg_state_counts"] = self.pg_ledger.pg_state_counts()
        return out

    def _asok_messenger_status(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok messenger status` (docs/TRACING.md
        "Wire plane"): reactor health (per-reactor loop lag, lag
        events), dispatch-executor depth/high-water and qwait/dispatch
        latency summaries, plus this daemon's wire totals."""
        out = self.messenger.ledger.status()
        out["osd"] = self.osd_id
        out["host_perf_owner"] = self._msgr_reporter
        out["reactors_conf"] = int(
            self.cct.conf.get("ms_async_op_threads")) or None
        out["daemon"] = self.messenger.stats.totals()
        return out

    def _asok_conn_profile(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok conn profile`: per-peer wire
        accounting — msgs/bytes in/out by message type, send-queue
        high-water, reconnects, replay frames, compress/encrypt
        bytes — from this daemon's bounded per-peer ring."""
        out = self.messenger.ledger.conn_profile(
            last=int(cmd["last"]) if "last" in cmd else None)
        out["osd"] = self.osd_id
        return out

    def _asok_launch_profile(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok launch profile`: the host flight
        recorder's launch ledger — aggregates, lat_launch_* percentile
        summaries, and the bounded ring of recent launches (each with
        launch id, jit bucket, runs/bytes/pg-mix, queue-wait, submit
        and device times, and the contributing ops' trace ids)."""
        out = self._profiler.profile(
            last=int(cmd["last"]) if "last" in cmd else None)
        out["osd"] = self.osd_id
        out["host_perf_owner"] = self._profiler_reporter
        return out

    def _maybe_prewarm(self) -> None:
        """Boot-time jit-bucket prewarm (ops/prewarm.py, conf
        osd_ec_prewarm): compile the expected bucket set BEFORE
        MOSDBoot, so the daemon never reports `up` with cold jit
        caches.  Process-level: the first in-process daemon to boot
        warms for the host (the caches are process-global); later
        booters reuse its status.  Never fails the boot."""
        if not bool(self.cct.conf.get("osd_ec_prewarm")):
            return
        try:
            from ..ec.interface import Profile
            from ..ec.registry import ErasureCodePluginRegistry
            from ..ops import prewarm
            prof = dict(
                kv.split("=", 1) for kv in str(self.cct.conf.get(
                    "osd_pool_default_erasure_code_profile")).split()
                if "=" in kv)
            # the card's plugin is "torch" where ceph_tpu names "jax"
            prof["plugin"] = prof.get("plugin") or "torch"
            prof = Profile(self._with_device(prof))
            codec = ErasureCodePluginRegistry.instance().factory(
                prof["plugin"], prof)
            with self._on_device():
                self._prewarm_status = prewarm.run_once(
                    codec, profiler=self._profiler,
                    budget_s=float(self.cct.conf.get(
                        "osd_ec_prewarm_budget_s")))
        except Exception as e:  # noqa: BLE001 — never a boot dependency
            self._prewarm_status = {"error": repr(e)}

    def _asok_prewarm_status(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok prewarm status`: the boot prewarm
        pass's plan/coverage/budget outcome plus the host-level
        prewarm tallies and persistent-cache state."""
        from ..ops import compile_cache, prewarm
        out = {
            "osd": self.osd_id,
            "enabled": bool(self.cct.conf.get("osd_ec_prewarm")),
            "boot": self._prewarm_status or prewarm.last_status(),
            "host": self._profiler.prewarm_summary(),
            "persistent_cache": compile_cache.status(),
        }
        return out

    def _asok_compile_ledger(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok compile ledger`: per-host compile
        attribution — every first-seen jit bucket with first-hit vs
        steady-state submit times (the difference is the compile),
        stall counts, and the COMPILE_STORM window summary."""
        out = self._profiler.compile_ledger()
        out["osd"] = self.osd_id
        out["storm_budget_s"] = float(self.cct.conf.get(
            "osd_ec_compile_storm_budget_s"))
        return out

    def _asok_mesh_status(self, cmd: dict) -> dict:
        """`ceph daemon osd.N.asok mesh status`: the host service's
        mesh + per-PG plane state (active / fallen-back / config
        error), so an operator can see exactly which plane serves
        which PG and why."""
        from ..parallel.service import MeshService
        svc = MeshService.get()
        with self.pg_lock:
            pgs = {str(pgid): st.backend.mesh_status()
                   for pgid, st in self.pgs.items()
                   if st.kind == "ec"}
        return {
            "osd": self.osd_id,
            "use_mesh": bool(self.cct.conf.get("osd_ec_use_mesh")),
            "mesh_devices": str(self.cct.conf.get("mesh_devices")),
            "service": svc.status() if svc is not None else None,
            "pgs": pgs,
        }

    # -- snap trim (reference PrimaryLogPG SnapTrimmer / snap trim queue;
    #    runs with scrub here: both walk the same object listing) ----------

    def _trim_snaps(self, state: PGState, pgid: pg_t, names) -> int:
        """Reclaim clones whose entire covered snap interval is in the
        pool's removed_snaps.  Resolution means clone c serves snaps in
        (max(prev_clone, born), c]; when every id in that window is
        deleted, nothing can ever read the clone again."""
        from dataclasses import replace
        from .snapset import SNAPDIR, SnapSet
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None or not pool.removed_snaps:
            return 0
        removed = set(pool.removed_snaps)
        be = state.backend
        trimmed = 0
        for head in {replace(o, snap=0) for o in names}:
            src = head
            ss, exists = self._head_snapset(state, pgid, src)
            if not exists:
                src = replace(head, snap=SNAPDIR)
                ss, exists = self._head_snapset(state, pgid, src)
                if not exists:
                    continue
            keep, lower, changed = [], 0, False
            for c in sorted(ss.clones):
                lo = max(lower, ss.born)
                window = set(range(lo + 1, c + 1))
                if window and window <= removed:
                    clone_oid = replace(head, snap=c)
                    if state.kind == "ec":
                        for s in range(be.n):
                            txn = Transaction()
                            txn.remove(shard_oid(clone_oid, s))
                            be.shards.sub_write(s, txn,
                                                lambda _s: None)
                    else:
                        for r in range(be.replicas.n_replicas):
                            txn = Transaction()
                            txn.remove(ghobject_t(clone_oid,
                                                  shard=NO_SHARD))
                            be.replicas.rep_write(r, txn,
                                                  lambda _r: None)
                    trimmed += 1
                    changed = True
                else:
                    keep.append(c)
                lower = c
            if changed:
                ss.clones = keep
                try:
                    self._bcast_head_txn(state, pgid, src, None, ss)
                except ErasureCodeError:
                    pass   # next trim pass retries
                state.snap_seqs.pop(head, None)
        return trimmed

    def _scrub_loop(self) -> None:
        """Background scheduler (reference PG scrub scheduling with
        min/deep intervals): shallow every osd_scrub_interval, deep
        every osd_deep_scrub_interval, optional auto-repair."""
        conf = self.cct.conf
        last_deep = time.time()
        interval = float(conf.get("osd_scrub_interval"))
        while not self._hb_stop.wait(interval):
            try:
                interval = float(conf.get("osd_scrub_interval"))
                deep_iv = float(conf.get("osd_deep_scrub_interval"))
                repair = bool(conf.get("osd_scrub_auto_repair"))
                deep = time.time() - last_deep >= deep_iv
                if deep:
                    last_deep = time.time()
                out = self._scrub_led_pgs(deep=deep, repair=repair)
                nerr = sum(len(r["errors"]) for r in out.values())
                if nerr:
                    self.cct.dout("osd", 1,
                                  f"background scrub: {nerr} errors "
                                  f"across {len(out)} pgs")
            except Exception as e:  # noqa: BLE001 - scheduler survives
                self.cct.dout("osd", 1, f"background scrub failed: {e!r}")

    # -- op tracking surveillance (reference OSD::check_ops_in_flight
    #    tick + the SLOW_OPS health path) -----------------------------------

    def _asok_dump_ops_in_flight(self, cmd: dict) -> dict:
        """Tracker-backed dump_ops_in_flight.  Keeps the pre-tracker
        output keys (pg / state / version) for compatibility and adds
        the tracker surface (age, current stage, trace id, events)."""
        if not self.op_tracker.enabled:
            # the reference returns an explicit error here; an empty
            # dump would affirmatively claim nothing is in flight
            return {"num_ops": 0, "ops": [],
                    "error": "op tracking disabled "
                             "(osd_enable_op_tracker=false)"}
        d = self.op_tracker.dump_ops_in_flight()
        for op in d["ops"]:
            op.setdefault("pg", "")
            op.setdefault("version", "0'0")
            op["state"] = op.get("current_stage", "")
        return d

    def _optrack_interval(self) -> float:
        ct = self.op_tracker.complaint_time
        return min(1.0, max(0.05, ct / 4.0)) if ct > 0 else 1.0

    def _optrack_loop(self) -> None:
        """Slow-op surveillance: latch over-complaint ops, report them
        to the mon (MOSDSlowOpReport -> `health` SLOW_OPS warning),
        and send one clearing report when the last slow op ages out so
        the warning retires."""
        last = 0
        while not self._hb_stop.wait(self._optrack_interval()):
            try:
                if not self.op_tracker.enabled:
                    if last:
                        # tracking turned off mid-warning: clear it at
                        # the mon instead of leaving it to go stale
                        self.mon_conn.send_message(M.MOSDSlowOpReport(
                            self.osd_id, {"count": 0, "oldest_age": 0.0,
                                          "ops": []}))
                        last = 0
                    continue
                # stamp wedged EC sub-writes (a known reduction: a
                # commit lost across a SIGKILL re-peer) onto their
                # op timelines so blame() names stuck_subwrite(pg)
                # instead of a generic "waiting after sub_write_sent"
                self._stuck_subwrites(mark=True)
                rep = self.op_tracker.slow_op_summary()
                if rep["count"] or last:
                    self.mon_conn.send_message(
                        M.MOSDSlowOpReport(self.osd_id, rep))
                last = rep["count"]
            except Exception:  # noqa: BLE001 - mon electing/shutdown
                pass

    # -- PG stats reporting (reference MPGStats via the mgr: the
    #    degraded/misplaced/unfound counts behind `ceph pg stat`,
    #    PG_DEGRADED health, and the split/merge interleave guard) ---------

    def _compile_pg_stats(self) -> dict:
        """Summarize this OSD's recovery/split/merge state: led PGs
        with recovery pending (degraded), objects with split/merge
        pushes in flight (misplaced), and latched-unfound objects,
        per pool and in total."""
        with self.pg_lock:
            needing = list(self._pgs_needing_recovery)
            # undersized-but-recovered PGs (down-not-out holes) are
            # degraded too — without them a down OSD whose data all
            # re-peered is invisible to PG_DEGRADED and mgr progress
            needing += [p for p in self._pgs_undersized
                        if p not in self._pgs_needing_recovery]
            pushes = list(self._split_push_pending)
            unfound = {pg: len(objs)
                       for pg, objs in self._unfound.items()}
            recovering = self._recovery_inflight
        pools: dict[str, dict] = {}

        def pool_rec(pool_id: int) -> dict:
            return pools.setdefault(str(pool_id), {
                "degraded_pgs": 0, "misplaced": 0, "unfound": 0,
                "push_seeds": []})

        for pgid in needing:
            pool_rec(pgid.pool)["degraded_pgs"] += 1
        seen_seeds: dict[str, set] = {}
        for child, _h in pushes:
            rec = pool_rec(child.pgid.pool)
            rec["misplaced"] += 1
            seen_seeds.setdefault(str(child.pgid.pool),
                                  set()).add(child.pgid.seed)
        for pid, seeds in seen_seeds.items():
            pools[pid]["push_seeds"] = sorted(seeds)[:128]
        for pg, n in unfound.items():
            pool_rec(pg.pool)["unfound"] += n
        rep = {
            "degraded_pgs": len(needing),
            "misplaced": len(pushes),
            "unfound": sum(unfound.values()),
            "recovering": recovering,
            "epoch": self.osdmap.epoch,
            "pools": pools,
        }
        # compile attribution monward (COMPILE_STORM, mon/monitor.py):
        # only the host profiler's perf-owner daemon reports — the
        # recorder is a HOST singleton, and every co-hosted daemon
        # re-reporting it would make the mon's sum read n_daemons x
        # the real compile seconds (the launch-queue perf rule)
        # control-plane ledger block (docs/TRACING.md "Control plane"):
        # cumulative, coarsely rounded, None while nothing happened —
        # so steady-state reports stay bit-identical and the
        # _pgstats_should_send dedup keeps its keepalive cadence
        lb = self.pg_ledger.pgstats_block()
        if lb is not None:
            rep["ledger"] = lb
        if self._profiler_reporter and self._profiler.enabled:
            w = self._profiler.compile_report()
            if w["events"]:
                rep["compile"] = {
                    "window_s": w["window_s"],
                    "compile_s": w["compile_s"],
                    "stalls": w["stalls"],
                    "worst_bucket": w["worst_bucket"],
                    "worst_s": w["worst_s"],
                    "budget_s": float(self.cct.conf.get(
                        "osd_ec_compile_storm_budget_s")),
                }
        # wire-plane ledger block (MSGR_REACTOR_LAG, mon/monitor.py):
        # same perf-owner rule as compile — the reactor pool is a host
        # singleton, so only one co-hosted daemon ships its lag
        # window; None while the window is empty keeps steady-state
        # reports bit-identical for the dedup above
        if self._msgr_reporter:
            mb = self.messenger.ledger.pgstats_block()
            if mb is not None:
                rep["msgr"] = mb
        return rep

    def _pgstats_should_send(self, rep: dict, now: float) -> bool:
        """A CHANGED report sends immediately (the mon's gates need
        fresh truth); an unchanged one only re-sends at the slower
        osd_pg_stat_keepalive cadence to refresh the mon's freshness
        window — steady state is O(cluster / keepalive) instead of
        O(cluster / tick) mon-bound report traffic."""
        if rep != self._pgstats_last_sent:
            return True
        return now - self._pgstats_last_time >= \
            float(self.cct.conf.get("osd_pg_stat_keepalive"))

    def _pgstats_loop(self) -> None:
        conf = self.cct.conf
        while not self._hb_stop.wait(
                float(conf.get("osd_pg_stat_interval") or 0.5)):
            try:
                rep = self._compile_pg_stats()
                self.perf.set("pg_degraded", rep["degraded_pgs"])
                self.perf.set("pg_misplaced", rep["misplaced"])
                self.perf.set("pg_unfound", rep["unfound"])
                now = time.time()
                if self._pgstats_should_send(rep, now):
                    self.mon_conn.send_message(
                        M.MPGStats(self.osd_id, rep))
                    self._pgstats_last_sent = rep
                    self._pgstats_last_time = now
            except Exception:  # noqa: BLE001 - mon electing/shutdown
                pass

    # -- heartbeats (reference OSD::handle_osd_ping / failure_queue) --------

    def _heartbeat_peers(self) -> list[int]:
        """Bounded heartbeat peer subset (reference OSD::maybe_update_
        heartbeat_peers + osd_heartbeat_min_peers): ring neighbors by
        OSD id.  Small clusters keep the full mesh; above the target
        count each OSD pings only ~osd_heartbeat_min_peers neighbors,
        and — because ring selection is symmetric — remains WATCHED by
        about as many, so the mon's failure-reporter quorum still
        trips without the O(N^2)-per-tick ping mesh."""
        import bisect
        peers = sorted(o.id for o in self.osdmap.osds.values()
                       if o.up and o.id != self.osd_id)
        want = max(2, int(self.cct.conf.get("osd_heartbeat_min_peers")))
        if len(peers) <= want:
            return peers
        i = bisect.bisect_left(peers, self.osd_id)
        half = (want + 1) // 2
        sel = {peers[(i + k) % len(peers)] for k in range(half)}
        sel |= {peers[(i - 1 - k) % len(peers)] for k in range(half)}
        return sorted(sel)

    def _note_hb_tick_lag(self, now_mono: float) -> float:
        """Tick-lag detector (evidence for compile-stall heartbeat
        flaps): seconds this tick started past its
        osd_heartbeat_interval schedule.  Sets the hb_tick_lag gauge
        every tick; a tick a full extra interval late counts in
        hb_tick_lag_events and logs — so when heartbeat grace trips,
        `perf dump` + the log say whether the DAEMON was starved
        (compile stall, GIL, load) rather than the peer dead."""
        last, self._hb_last_tick = self._hb_last_tick, now_mono
        if last is None:
            return 0.0
        lag = (now_mono - last) - self.heartbeat_interval
        self.perf.set("hb_tick_lag", round(max(0.0, lag), 6))
        # the inter-tick gap legitimately includes the previous
        # body's work (pings, mon RPC), so the event/log threshold
        # is a FULL extra interval — the ping cadence effectively
        # halved, eating real margin out of peers' grace windows —
        # not the half-interval a busy healthy body routinely costs
        if lag >= self.heartbeat_interval:
            self.perf.inc("hb_tick_lag_events")
            self.cct.dout(
                "osd", 1,
                f"heartbeat tick delayed {lag:.3f}s past "
                f"osd_heartbeat_interval={self.heartbeat_interval}s "
                f"(loop starved: first-bucket compile / load?)")
        return lag

    def _heartbeat_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_interval):
            self._note_hb_tick_lag(time.perf_counter())
            now = time.time()
            # mon keepalive + hunting: no map traffic for too long means
            # our mon may be dead — rotate to the next one and
            # re-announce (reference MonClient::tick hunting).  The
            # keepalive carries our epoch, so a current daemon's tick
            # earns a ~zero-byte ack instead of a full-map payload
            # (counted in the mon's map_keepalive_sends).
            try:
                self.mon_conn.send_message(
                    M.MMonGetMap(have_epoch=self.osdmap.epoch))
                stale = max(2.0, 4 * self.heartbeat_interval)
                if len(self.mon_addrs) > 1 and \
                        now - self._last_map_time > stale:
                    self._mon_idx = (self._mon_idx + 1) % \
                        len(self.mon_addrs)
                    self.mon_conn = self.messenger.connect(
                        self.mon_addrs[self._mon_idx])
                    self._last_map_time = now
                    self.mon_conn.send_message(
                        M.MMonGetMap(have_epoch=self.osdmap.epoch))
                    self.mon_conn.send_message(
                        M.MOSDBoot(self.osd_id, self.addr))
            except Exception:  # noqa: BLE001
                pass
            peers = [self.osdmap.osds[oid]
                     for oid in self._heartbeat_peers()
                     if oid in self.osdmap.osds]
            for o in peers:
                try:
                    # lossy: a dead peer must not accumulate a replay
                    # window of stale pings (reference runs heartbeats on
                    # dedicated lossy messengers)
                    self.messenger.connect(
                        tuple(o.addr), lossless=False).send_message(
                        M.MOSDPing(self.osd_id, self.osdmap.epoch,
                                   stamp=now))
                except Exception:  # noqa: BLE001
                    pass
                # A peer that has never answered counts from its first
                # ping, so silence-from-birth is also reported (reference
                # OSD.cc:5210 ping accounting tracks first_tx per peer).
                self._hb_first_ping.setdefault(o.id, now)
                last = self._hb_last_seen.get(o.id,
                                              self._hb_first_ping[o.id])
                # osd_heartbeat_grace was declared but never read —
                # the multiplier was hardcoded at its default of 4;
                # loaded many-daemon boxes need it tunable
                grace = self.heartbeat_interval * \
                    float(self.cct.conf.get("osd_heartbeat_grace"))
                if now - last > grace:
                    self.mon_conn.send_message(M.MOSDFailure(
                        self.osd_id, o.id, self.osdmap.epoch))

    def _handle_ping(self, conn, msg: M.MOSDPing) -> None:
        self._hb_last_seen[msg.from_osd] = time.time()
        if not msg.is_reply:
            conn.send_message(M.MOSDPing(self.osd_id, self.osdmap.epoch,
                                         is_reply=True, stamp=msg.stamp))

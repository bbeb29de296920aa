"""Typed option schema + layered runtime config.

Re-expresses the reference's config system (src/common/options.cc —
1,602 Option() entries with type/default/min/max/enum/level/flags/
see_also — and md_config_t, src/common/config.h:55): a single typed
schema, values layered  compiled defaults < conf file < mon central
config < env < cli < injectargs,  and observer callbacks fired on
runtime change.

Only the options this framework actually reads are declared (new ones
register at import time from the subsystem that owns them — same
discipline as the reference's per-component option blocks).

The port's copy of ceph_tpu/common/options.py: every option and default
is kept (the tpu_* keys and the CEPH_TPU_<OPTION> env layer too, so one
conf file configures either package), with two changes.  The card's
plugin is `torch`, so the default plugin list and the default EC
profile name it where the reference names `jax`.  The compile-cache and
prewarm descriptions say what they do on the card (ops/compile_cache.py,
ops/prewarm.py): there is no per-shape compile there.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Any, Callable


class Level(IntEnum):
    BASIC = 0
    ADVANCED = 1
    DEV = 2


@dataclass
class Option:
    name: str
    type: type                   # int, float, str, bool
    default: Any
    desc: str = ""
    level: Level = Level.ADVANCED
    min: float | None = None
    max: float | None = None
    enum_values: tuple | None = None
    see_also: tuple = ()
    flags: tuple = ()            # e.g. ("startup",)

    def validate(self, value: Any) -> Any:
        if self.type is bool and isinstance(value, str):
            value = value.lower() in ("true", "1", "yes", "on")
        value = self.type(value)
        if self.min is not None and value < self.min:
            raise ValueError(f"{self.name}={value} < min {self.min}")
        if self.max is not None and value > self.max:
            raise ValueError(f"{self.name}={value} > max {self.max}")
        if self.enum_values and value not in self.enum_values:
            raise ValueError(
                f"{self.name}={value!r} not in {self.enum_values}")
        return value


SCHEMA: dict[str, Option] = {}


def register_options(opts: list[Option]) -> None:
    for o in opts:
        SCHEMA[o.name] = o


register_options([
    # EC (reference options.cc:564, :2610-2613); the card's plugin is
    # "torch" where ceph_tpu names "jax"
    Option("erasure_code_dir", str, "",
           "directory for out-of-tree EC plugins", Level.ADVANCED,
           flags=("startup",)),
    Option("osd_erasure_code_plugins", str, "jerasure isa torch",
           "EC plugins to preload at daemon start", Level.ADVANCED,
           flags=("startup",)),
    Option("osd_pool_default_erasure_code_profile", str,
           "plugin=torch technique=cauchy k=8 m=3",
           "default EC profile for new pools"),
    # messenger
    Option("ms_dispatch_workers", int, 64,
           "dispatcher thread pool width", Level.ADVANCED, min=1),
    Option("ms_crc_data", bool, True, "crc-protect message payloads"),
    Option("ms_inject_socket_failures", int, 0,
           "inject a socket reset roughly every N frames (0 = off; "
           "reference ms_inject_socket_failures, options.cc:1071)",
           min=0),
    Option("ms_inject_delay_probability", float, 0.0,
           "probability of delaying a frame write (reference "
           "ms_inject_delay_probability)", min=0.0, max=1.0),
    Option("ms_inject_delay_max", float, 0.1,
           "max injected delay in seconds", min=0.0),
    Option("ms_compress", str, "",
           "on-wire frame compression algorithm (reference msgr2.1 "
           "compression / ms_osd_compress_mode); empty = off",
           enum_values=("", "zlib", "bz2", "lzma")),
    Option("ms_compress_min_size", int, 4096,
           "only compress frames at least this large (reference "
           "ms_osd_compress_min_size)", min=0),
    Option("ms_async_op_threads", int, 0,
           "reactor pool size (reference ms_async_op_threads); 0 = "
           "auto (max(1, min(4, cpu_count))).  Startup-only: the pool "
           "is created with the first messenger and pinned loops "
           "cannot be resized live", min=0, max=64,
           flags=("startup",)),
    Option("ms_sync_timeout", float, 30.0,
           "deadline of the blocking bridge into the reactor "
           "(Messenger._run_sync; was a hardcoded 30 s); expiries "
           "count in the wire ledger's msgr_sync_timeouts", min=0.1),
    # wire-plane flight recorder (docs/TRACING.md "Wire plane")
    Option("ms_ledger", bool, True,
           "record per-connection wire accounting, reactor loop-lag "
           "probes and dispatch-executor wait/run histograms in the "
           "wire-plane ledger (msg/msgr_ledger.py): feeds the "
           "`messenger status` / `conn profile` asoks, the MPGStats "
           "msgr block, the MSGR_REACTOR_LAG health warning and "
           "cluster_bench's msgr_ledger rows; off = the null fast "
           "path"),
    Option("ms_ledger_peers", int, 256,
           "peers kept per messenger in the bounded per-connection "
           "table (oldest evicted past the cap)", Level.DEV, min=1),
    Option("ms_reactor_lag_interval", float, 0.25,
           "seconds between reactor loop-lag probe fires; a probe "
           "arriving a FULL extra interval late counts as a lag event "
           "(the heartbeat tick-lag rule)", min=0.01),
    Option("ms_reactor_lag_warn_s", float, 1.0,
           "worst in-window reactor lag above which the mon raises "
           "the MSGR_REACTOR_LAG health warning (rides the MPGStats "
           "msgr block, so the mon needs no config)", min=0.0),
    Option("ms_inject_dispatch_stall", float, 0.0,
           "fault injection: sleep this long in the messenger send "
           "path before every wire write — a stalled dispatch for the "
           "slow-op blame / ledger gates", Level.DEV, min=0.0),
    # osd
    Option("osd_heartbeat_interval", float, 1.0,
           "seconds between peer pings", min=0.05),
    Option("osd_heartbeat_grace", float, 4.0,
           "missed-ping multiplier before reporting failure", min=1.0),
    Option("osd_heartbeat_min_peers", int, 10,
           "target heartbeat peer count (reference "
           "osd_heartbeat_min_peers): above this many up OSDs, each "
           "daemon pings only its ring neighbors by id instead of the "
           "full O(N^2) mesh — every OSD stays watched by ~this many "
           "reporters, which is what the mon's failure quorum needs",
           min=2),
    Option("osd_pg_stat_keepalive", float, 3.0,
           "re-send cadence for an UNCHANGED MPGStats report: a "
           "changed report still sends every osd_pg_stat_interval "
           "tick, but steady-state identical reports only refresh "
           "the mon's freshness window at this slower pace (must sit "
           "well inside the mon's 10 s PG_STAT_FRESH horizon)",
           min=0.1, max=8.0),
    Option("osd_pool_default_pg_num", int, 8, "default pg count", min=1),
    Option("osd_op_queue", str, "wpq", "op scheduler",
           enum_values=("wpq", "mclock")),
    # mClock QoS (reference osd_mclock_profile + the dmclock
    # reservation/weight/limit triples it expands to; docs/QOS.md)
    Option("osd_mclock_profile", str, "balanced",
           "named (reservation, weight, limit) preset per op class",
           enum_values=("balanced", "high_client_ops",
                        "high_recovery_ops", "custom")),
    Option("osd_mclock_custom_profile", str, "",
           "per-class overrides applied on top of the named profile: "
           "'class:res,wgt,lim;...' (res/lim in ops/sec, 0 = none); "
           "also how tenant classes get their QoS triples"),
    Option("osd_max_backfills", int, 1,
           "concurrent recovery ops per OSD", min=1),
    # repair subsystem (docs/REPAIR.md)
    Option("osd_ec_read_timeout", float, 30.0,
           "seconds a degraded EC client-read fan-out waits for shard "
           "replies before widening to parity shards / giving up; "
           "expiries count in the ec_read_timeouts perf counter "
           "(was a hardcoded 30 s in ec_backend.read)", min=0.05),
    Option("osd_ec_clay_repair", bool, True,
           "serve single-shard repair of sub-chunked (CLAY) pools "
           "from repair-plane reads + the batched GF-matmul repair "
           "plan (1/q of each helper chunk read, d helpers); off = "
           "always full-read decode"),
    Option("osd_recovery_max_bytes_per_sec", int, 0,
           "repair-bandwidth throttle: cap on rebuilt shard bytes "
           "pushed per second per OSD (token bucket; 0 = unlimited).  "
           "Client reads of degraded objects are NOT throttled — they "
           "reconstruct inline via reconstruct-on-read", min=0),
    Option("osd_recovery_sleep", float, 0.0,
           "seconds to pause between recovery object pushes "
           "(reference osd_recovery_sleep); coarse-grain brake "
           "alongside the byte-rate throttle", min=0.0),
    Option("osd_scrub_auto", bool, False, "run background scrub"),
    Option("osd_scrub_interval", float, 60.0,
           "seconds between background shallow scrubs (reference "
           "osd_scrub_min_interval)", min=0.1),
    Option("osd_deep_scrub_interval", float, 600.0,
           "seconds between background deep scrubs (reference "
           "osd_deep_scrub_interval)", min=0.1),
    Option("osd_scrub_auto_repair", bool, False,
           "repair inconsistencies found by background scrub "
           "(reference osd_scrub_auto_repair)"),
    Option("osd_pg_stat_interval", float, 0.5,
           "seconds between MPGStats reports to the mon (degraded/"
           "misplaced/unfound counts + pending split/merge pushes; "
           "reference mgr stats period).  Capped well below the "
           "mon's 10s report-freshness window (PG_STAT_FRESH) — a "
           "report that expires before its renewal would make the "
           "ok-to-stop/safe-to-destroy/merge gates flap EAGAIN",
           min=0.05, max=5.0),
    # op tracking (reference TrackedOp/OpTracker options)
    Option("osd_enable_op_tracker", bool, True,
           "track per-op event timelines (reference "
           "osd_enable_op_tracker; off = zero-cost null path)"),
    Option("osd_op_complaint_time", float, 30.0,
           "seconds before an op latches as slow and is reported to "
           "the mon (reference osd_op_complaint_time)", min=0.0),
    Option("osd_op_history_size", int, 20,
           "completed ops kept for dump_historic_ops (reference "
           "osd_op_history_size)", min=0),
    Option("osd_op_history_slow_size", int, 20,
           "slow ops kept for dump_historic_slow_ops (reference "
           "osd_op_history_slow_op_size)", min=0),
    # tpu data plane
    Option("tpu_encode_tile", int, 8192,
           "byte-axis tile of the GF matmul kernel", Level.DEV, min=128),
    Option("tpu_fused_crc", bool, True,
           "emit shard crc32c from the encode launch", Level.DEV),
    Option("tpu_batch_window_ms", float, 0.0,
           "max time to hold EC ops for cross-transaction batching",
           Level.DEV, min=0.0),
    Option("ec_dispatch_ahead_depth", int, 2,
           "max encode drains kept in flight on the device before the "
           "completion stage materializes the oldest (dispatch-ahead "
           "pipeline, docs/PIPELINE.md)", Level.DEV, min=1),
    Option("ec_dispatch_ahead", bool, False,
           "hold an always-open dispatch-ahead window on EC backends "
           "(drains materialize when pushed out by depth or by the "
           "flush timer instead of synchronously)", Level.DEV),
    Option("ec_dispatch_flush_ms", float, 2.0,
           "idle flush timer for the always-open dispatch-ahead window",
           Level.DEV, min=0.1),
    Option("osd_deep_scrub_device", bool, True,
           "verify deep-scrub crc32c with the device kernel when an "
           "accelerator backend is active (host crc fallback otherwise)",
           Level.DEV),
    # per-host EC launch queue (cross-PG continuous batching on the
    # MeshService seam; docs/PIPELINE.md "Host launch queue")
    Option("osd_ec_host_batch", bool, True,
           "route EC encode launches of every PG on the host through "
           "one per-device launch queue that coalesces runs from "
           "different PGs into super-batch launches (per-PG in-order "
           "completion and failure containment preserved); off = each "
           "PG launches its own drains"),
    Option("osd_ec_host_batch_window_us", float, 250.0,
           "max microseconds a submitted run waits in the host launch "
           "queue for co-batching before the window fires; 0 launches "
           "every submission immediately (no cross-PG batching).  A "
           "ticket finalized earlier flushes the queue on demand, so "
           "a lone synchronous writer never waits the window out",
           min=0.0),
    Option("osd_ec_host_batch_max_bytes", int, 32 << 20,
           "input-byte cap per super-batch launch (the occupancy "
           "denominator of the launch-queue counters); reaching it "
           "launches immediately", min=1 << 16),
    # device-plane flight recorder (docs/TRACING.md "Device plane")
    Option("osd_ec_profiler", bool, True,
           "record every device launch (fused/plain encode, decode, "
           "CLAY repair, scrub CRC) in the per-host launch ledger "
           "with compile attribution; off = the null fast path "
           "(ops/profiler.py)"),
    Option("osd_ec_profiler_ring", int, 256,
           "completed launch records kept in the flight-recorder "
           "ring (the `launch profile` asok tail)", Level.DEV,
           min=1, flags=("startup",)),
    Option("osd_ec_compile_stall_s", float, 0.25,
           "a first-seen jit bucket whose submit wall time exceeds "
           "this counts as a compile stall (ec_compile_stalls, "
           "slow-op first_compile blame, COMPILE_STORM events)",
           min=0.0),
    Option("osd_ec_compile_storm_budget_s", float, 5.0,
           "compile seconds inside the storm window above which the "
           "mon raises the COMPILE_STORM health warning", min=0.0),
    Option("osd_ec_compile_storm_window_s", float, 60.0,
           "sliding window for the COMPILE_STORM compile-seconds "
           "budget", min=1.0),
    Option("osd_ec_inject_compile_stall", float, 0.0,
           "fault injection: sleep this long inside the submit of "
           "every FIRST-seen jit bucket (a synthetic compile stall "
           "for the smoke/health gates)", Level.DEV, min=0.0),
    # control-plane flight recorder (docs/TRACING.md "Control plane")
    Option("osd_pg_ledger", bool, True,
           "record every PG peering/recovery/backfill transition in "
           "the per-PG state-machine ledger (osd/pg_ledger.py): "
           "timed stages feed lat_peering_*/lat_recovery_* "
           "histograms, the `pg ledger` asok, the MPGStats ledger "
           "block, and cluster_bench's recovery_blame rows; off = "
           "the null fast path"),
    Option("osd_pg_ledger_ring", int, 64,
           "state transitions kept per PG in the control-plane "
           "ledger ring (the `pg ledger` asok transition tail)",
           Level.DEV, min=1, flags=("startup",)),
    Option("osd_stuck_subwrite_s", float, 10.0,
           "an EC client write whose shard sub-writes have been in "
           "flight longer than this is surfaced as stuck_subwrite(pg) "
           "in `repair status` and slow-op blame (the PR 16 known "
           "reduction: a write wedged across a SIGKILL re-peer must "
           "be visible, not a silent active+clean stall)", min=0.0),
    # compile lifecycle: the kernel library cache + boot prewarm
    # (ops/compile_cache.py, ops/prewarm.py)
    Option("osd_ec_compile_cache", bool, True,
           "keep the nvcc-built CUDA kernel library in a directory "
           "that outlives the process (ops/compile_cache.py): a "
           "restarted daemon loads the library built for its source "
           "hash and runs no nvcc; such loads surface in the compile "
           "ledger as fast first launches, not stalls",
           flags=("startup",)),
    Option("osd_ec_compile_cache_dir", str, "",
           "kernel library directory; empty = ceph_tpu_torch/build/ "
           "(CEPH_TPU_TORCH_COMPILE_CACHE also honored).  One "
           "directory per host — the first daemon to enable it wins",
           flags=("startup",)),
    Option("osd_ec_prewarm", bool, False,
           "run the expected launch-bucket set at OSD boot BEFORE the "
           "daemon reports up (ops/prewarm.py): fused-drain widths x "
           "run counts at the autotuned point, plain-encode and "
           "decode shapes, so the kernel library, the CUDA context, "
           "each kernel's module and the pinned staging blocks are "
           "warm.  Off by default to keep unit-test boots cheap",
           flags=("startup",)),
    Option("osd_ec_prewarm_budget_s", float, 8.0,
           "wall-clock cap on the boot-time prewarm pass; on cutoff "
           "the plan is marked truncated and the daemon boots with "
           "whatever was warmed (prewarm is an optimization, never a "
           "boot dependency)", min=0.0, flags=("startup",)),
    # multichip mesh scale-out (docs/MULTICHIP.md)
    Option("osd_ec_use_mesh", bool, False,
           "acquire the per-host MeshService multichip data plane for "
           "EC PGs: batched drains and distributed repair run as "
           "sharded contractions across the device mesh; "
           "geometry/matrix mismatches log a config error and fall "
           "back to the single-chip codec", flags=("startup",)),
    Option("mesh_devices", str, "",
           "device mesh shape 'SHARDxDATA' (e.g. '4x2') or a device "
           "count; empty = all visible devices with the default "
           "shard-axis heuristic.  One mesh per host: the first "
           "daemon to configure it wins", flags=("startup",)),
])

# rgw bucket index sharding / dynamic resharding / quota admission
# (rgw/bucket_index.py, rgw/reshard.py, rgw/store.py); reference
# option names match src/common/options/rgw.yaml.in where one exists
register_options([
    Option("rgw_bucket_index_shards", int, 1,
           "index shard count for newly created buckets (reference "
           "rgw_override_bucket_index_max_shards); 1 keeps the legacy "
           "single directory object layout", min=1),
    Option("rgw_max_objs_per_shard", int, 100_000,
           "dynamic-reshard trigger: when a bucket's entry count "
           "exceeds shards*this, the reshard sweep scales the shard "
           "count to the next power of two that brings the per-shard "
           "load back under it", min=1),
    Option("rgw_reshard_max_shards", int, 64,
           "ceiling on automatic reshard targets (manual 'bucket "
           "reshard' may still exceed it)", min=1),
    Option("rgw_reshard_grace_s", float, 0.25,
           "dwell in the dual-write state before copying begins: "
           "writers that read the bucket meta just before the reshard "
           "marker landed finish their single-layout writes inside "
           "this window, so the copier's old-shard pages see them",
           min=0.0),
    Option("rgw_reshard_batch", int, 512,
           "entries per dir_merge page while copying a shard (one "
           "atomic class call each)", min=1),
    Option("rgw_quota_reservation_ttl_s", float, 30.0,
           "lifetime of a cls_user quota reservation; a writer that "
           "died between reserve and release stops counting against "
           "its user's quota after this", min=0.0),
])


class Config:
    """Layered md_config_t equivalent with change observers."""

    LAYERS = ("default", "file", "mon", "env", "cli", "override")

    def __init__(self) -> None:
        self._layers: dict[str, dict[str, Any]] = {
            layer: {} for layer in self.LAYERS}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        self._lock = threading.RLock()
        for name, opt in SCHEMA.items():
            self._layers["default"][name] = opt.default
        # CEPH_TPU_<OPTION> env overrides (reference env layer)
        for name in SCHEMA:
            env = os.environ.get(f"CEPH_TPU_{name.upper()}")
            if env is not None:
                self._layers["env"][name] = SCHEMA[name].validate(env)

    def get(self, name: str) -> Any:
        with self._lock:
            for layer in reversed(self.LAYERS):
                if name in self._layers[layer]:
                    return self._layers[layer][name]
        raise KeyError(f"unknown option {name}")

    def set(self, name: str, value: Any, layer: str = "override") -> None:
        opt = SCHEMA.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name}")
        value = opt.validate(value)
        with self._lock:
            old = self.get(name)
            self._layers[layer][name] = value
            observers = list(self._observers.get(name, []))
        if value != old:
            for cb in observers:
                cb(name, value)

    def apply_mon_layer(self, values: dict[str, Any]) -> None:
        """Replace the 'mon' layer wholesale with the central-config
        sections relevant to this daemon (reference ConfigMonitor ->
        MConfig push).  Keys the schema doesn't know are skipped (a
        newer mon may carry options this build lacks); observers fire
        for every effectively-changed option — including ones whose
        mon override was REMOVED (they fall back to a lower layer)."""
        validated: dict[str, Any] = {}
        for name, raw in values.items():
            opt = SCHEMA.get(name)
            if opt is None:
                continue
            try:
                validated[name] = opt.validate(raw)
            except (ValueError, TypeError):
                continue
        with self._lock:
            touched = set(self._layers["mon"]) | set(validated)
            old = {name: self.get(name) for name in touched}
            self._layers["mon"] = validated
            changed = [(name, self.get(name)) for name in touched
                       if self.get(name) != old[name]]
            observers = [(cb, name, val) for name, val in changed
                         for cb in self._observers.get(name, [])]
        for cb, name, val in observers:
            # isolate observer failures: the layer is already swapped,
            # so a skipped notification would never be retried — one
            # bad consumer must not eat its siblings' callbacks
            try:
                cb(name, val)
            except Exception:  # noqa: BLE001
                import traceback
                traceback.print_exc()

    def add_observer(self, name: str,
                     cb: Callable[[str, Any], None]) -> None:
        with self._lock:
            self._observers.setdefault(name, []).append(cb)

    def show(self) -> dict[str, Any]:
        with self._lock:
            return {name: self.get(name) for name in sorted(SCHEMA)}

    def inject_args(self, args: str) -> None:
        """`injectargs`-style "--opt value --flag" runtime updates."""
        toks = args.split()
        i = 0
        while i < len(toks):
            name = toks[i].lstrip("-").replace("-", "_")
            if i + 1 < len(toks) and not toks[i + 1].startswith("--"):
                self.set(name, toks[i + 1])
                i += 2
            else:
                self.set(name, True)
                i += 1

"""Per-host EC launch queue: cross-PG continuous batching on the card.

The port of ceph_tpu/parallel/launch_queue.py.  A loaded OSD host with
many PGs would issue many partial-occupancy launches, because every
ECBackend drains per PG; instead every ECBackend on the host submits its
assemble-complete runs here, and the queue coalesces runs from
DIFFERENT PGs into one launch per window.  Four submit kinds, each
reaching the kernels through its plugin or plan:

  "x" submit_extents      fused parity + crc32c runs:
                          ErasureCodeTorch.encode_extents_with_crc_submit
                          / _finalize (K3 at combine="kernel", else K2)
  "c" submit_chunks       plain parity, columns concatenated:
                          encode_chunks_submit / _finalize (K1)
  "d" submit_decode       recovery / reconstruct-on-read decodes sharing
                          (codec, erasure pattern): decode_chunks (K1)
  "r" submit_clay_repair  CLAY repair-plan applies sharing a plan
                          signature: ClayRepairPlan.apply (K4)

Why concatenation is safe: the fused extents contract pads every run to
a block multiple and returns one L per (run, shard), and parity, decode
and the repair apply are columnwise-linear GF(2^8) maps, so a launch
over many submissions' columns demultiplexes exactly.

Contract with the owning backends:

* `submit_*` returns a `LaunchTicket` immediately.  The queue launches a
  key's pending submissions when the batching window (`window_us`)
  expires, when their input bytes reach `max_bytes`, or when any
  ticket's `result()` is called first (flush-on-demand: a lone PG keeps
  its synchronous flush-on-idle semantics).
* Per-PG in-order completion is untouched: the queue owns the launch;
  each backend materializes its drains in its own submit order.
* Submissions coalesce only when their codecs are provably identical
  (`codec_signature`).  If a combined launch still fails, the queue
  re-issues each submission through the SAME device entry on its own
  plugin, counted in `ec_host_launch_retries`, so a poison run fails
  only its owner's ticket.  A finalize failure fails every ticket of
  that batch and the queue keeps serving.  No path moves to a kernel's
  plain version: the plugins run their kernels on their own device.

Differences from the reference:

* The queue names its device (`device=`, the card unless the caller
  passes "cpu"; a CUDA request without a GPU raises).  Launches from
  the window worker or a finalizer that steals a launch run under
  `torch.cuda.device(self.device)`, since the current card is per
  thread, and a submission whose plugin or plan lives on another device
  is refused.  Each plugin records its event on the launching thread's
  current stream and keeps its pinned staging tensors in the handle
  until finalize.  A plugin's own lock (ec_torch's decode-plan cache)
  is taken inside a launch and holds no queue lock, so the lock order
  stays acyclic.
* The reference pads coalesced "c" and "d" launches to a power-of-two
  width so that XLA compiles a bounded set of jit buckets.  The card
  compiles nothing per width, so the port launches the real width (pad
  columns were never read); the flight recorder's bucket label records
  it.  DECODE_MAX_LAUNCH_W keeps the reference's value, so launch
  counts match.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.profiler import device_profiler

# max summed input width of one coalesced decode launch (the reference's
# value, which bounded its decode jit buckets; kept so the launch counts
# match).  A single submission wider than the cap launches alone (a
# recovery group's chunk is atomic).
DECODE_MAX_LAUNCH_W = 65536


def _codec_label(plugin) -> str:
    """Short human codec tag for the flight recorder (the full
    codec_signature carries raw matrix bytes)."""
    try:
        return (f"{type(plugin).__name__}:"
                f"k{plugin.get_data_chunk_count()}"
                f"m{plugin.get_coding_chunk_count()}")
    except AttributeError:       # plans carry no geometry getters
        return type(plugin).__name__


def _extents_bucket(handle) -> str:
    """Launch-bucket label of a fused-extents submit handle: its path,
    launch width and run count."""
    if isinstance(handle, dict):
        if "split" in handle:
            return "+".join(_extents_bucket(h)
                            for _idx, h in handle["split"])
        return (f"x:{handle.get('path')}:w{handle.get('big_width')}"
                f":r{len(handle.get('meta', ()))}")
    return "x:opaque"


def codec_signature(plugin) -> tuple:
    """Coalescing key for a plugin instance: two submissions may share
    one launch only when this is equal — same geometry AND bit-equal
    generator matrix.  Plugins may provide their own
    `codec_signature()`; without a generator matrix the signature
    degrades to instance identity, so such plugins still batch with
    themselves but never across instances."""
    own = getattr(plugin, "codec_signature", None)
    if callable(own):
        return own()
    mat = getattr(plugin, "matrix", None)
    if mat is None or \
            not getattr(plugin, "matrix_determines_encode", False):
        # exposing a matrix is NOT proof the encode uses it (jerasure's
        # minimal-density techniques encode via bitmatrix packets) —
        # only plugins that explicitly declare matrix-determined
        # encode semantics may batch across instances on the matrix
        return ("instance", id(plugin))
    # plugin-typed: the launch runs through the FIRST submitter's
    # plugin, so two plugin classes with bit-equal matrices never
    # co-batch on the matrix alone
    return (type(plugin).__name__,) + matrix_signature(
        mat, plugin.get_data_chunk_count(),
        plugin.get_coding_chunk_count())


def matrix_signature(matrix, k, m) -> tuple:
    """The geometry + bit-equal-generator-matrix fields every
    coalescing key shares.  The RAW matrix bytes ride the key: a hash
    would make "provably identical" probabilistic."""
    a = np.ascontiguousarray(np.asarray(matrix))
    return (int(k), int(m), a.shape, a.tobytes())


class LaunchQueueError(RuntimeError):
    """A ticket whose launch/finalize died; the owning backend aborts
    its drain's ops (never other PGs')."""


class _Sub:
    """One backend drain's submission (all its fused runs, its one
    concatenated plain chunk run, or one recovery decode / CLAY repair
    run).  `extra` carries kind-specific launch arguments (the decode
    erasure list)."""
    __slots__ = ("ticket", "plugin", "runs", "n_runs", "width",
                 "nbytes", "t_submit", "owner", "extra", "traces")

    def __init__(self, ticket, plugin, runs, owner, extra=None,
                 traces=()):
        self.ticket = ticket
        self.plugin = plugin
        self.runs = runs
        self.n_runs = len(runs)
        self.width = runs[0].shape[1]
        self.nbytes = sum(r.shape[0] * r.shape[1] for r in runs)
        self.t_submit = time.perf_counter()
        self.owner = owner
        self.extra = extra
        # trace ids of the ops whose bytes ride this submission: the
        # flight recorder's LaunchRecord carries them, so a slow op's
        # blame names its launch and the launch names its ops
        self.traces = traces


class _Batch:
    """One launched super-batch.  `combined` holds the shared handle
    (launched through the first submission's plugin); `per_sub` holds
    the per-submission re-issue after a combined-launch failure."""

    def __init__(self, kind: str, subs: list[_Sub]):
        self.kind = kind
        self.subs = subs
        self.lock = threading.Lock()
        # set once _do_launch has issued (or re-issued) the device
        # submit; finalizers wait on it
        self.launch_done = threading.Event()
        # one-shot claim on the device submit: a finalizer whose batch
        # is still unclaimed steals the launch instead of waiting
        # behind another key's batch in the window worker's loop
        self._launch_claim = threading.Lock()
        self.finalized = False
        self.combined = None        # (plugin, handle)
        self.per_sub = None         # [(sub, handle | None)]
        self.path = None
        self.queue_wait = 0.0
        self.prof_rec = None


class LaunchTicket:
    """What a backend drain holds instead of a plugin submit handle.
    `result()` blocks until the super-batch containing this submission
    has launched (forcing the launch if the window hasn't fired) and
    finalized, then returns this submission's share of the results."""

    is_launch_ticket = True

    def __init__(self, queue: "ECLaunchQueue", kind: str, key: tuple):
        self._queue = queue
        self.kind = kind
        self._key = key
        self._batch: _Batch | None = None
        self._result = None
        self._error: Exception | None = None
        self._done = False
        self.path: str | None = None
        self.cancelled = False
        # flight-recorder stitching (ops/profiler.py): filled at launch
        # so the owning backend can put the launch id (and a
        # first-compile blame event) on its ops' timelines
        self.launch_id: int | None = None
        self.bucket: str | None = None
        self.compiled = False
        self.compile_s = 0.0
        self.cache_hit = False

    @property
    def launched(self) -> bool:
        return self._batch is not None

    def cancel(self) -> None:
        """Withdraw a not-yet-launched submission (the owning drain
        died during its own submit half); post-launch this is a no-op
        and the results are simply never read."""
        self._queue._cancel(self)

    def result(self):
        if not self._done:
            if self._batch is None:
                self._queue.flush(self._key)
            batch = self._batch
            if batch is None:
                if self._error is None:
                    self._error = LaunchQueueError(
                        "launch ticket cancelled before launch")
            else:
                self._queue._finalize_batch(batch)
        if self._error is not None:
            raise self._error
        return self._result


def _build_queue_perf(name: str):
    from ..common.perf_counters import PerfCountersBuilder
    return (PerfCountersBuilder(name)
            .add_u64_counter("ec_host_launches",
                             "super-batch device launches issued")
            .add_u64_counter("ec_host_launch_runs",
                             "extent runs coalesced into launches")
            .add_u64_counter("ec_host_launch_bytes",
                             "input bytes coalesced into launches")
            .add_u64_counter("ec_host_launch_pg_mix",
                             "sum of distinct submitters per launch")
            .add_u64_counter("ec_host_cross_pg_launches",
                             "launches coalescing >1 PG's runs")
            .add_u64_counter("ec_host_launch_retries",
                             "combined launches re-issued per "
                             "submission (containment)")
            .add_u64_counter("ec_host_launch_errors",
                             "submissions whose launch failed")
            .add_u64_counter("ec_host_decode_launches",
                             "recovery/reconstruct decode super-batch "
                             "launches")
            .add_u64_counter("ec_host_repair_launches",
                             "CLAY repair-plan super-batch launches")
            .add_gauge("ec_host_occupancy_pct",
                       "last launch bytes / max super-batch bytes")
            .add_histogram("lat_ec_batch_wait",
                           "submit -> launch batching wait")
            .create_perf_counters())


class ECLaunchQueue:
    """The per-host EC launch queue, on one device."""

    # one queue per host
    _host: "ECLaunchQueue | None" = None
    _host_lock = threading.Lock()

    def __init__(self, window_us: float = 250.0,
                 max_bytes: int = 32 << 20, perf=None,
                 perf_name: str = "ec_host_queue",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.window_us = float(window_us)
        self.max_bytes = max(1, int(max_bytes))
        self.perf = perf if perf is not None \
            else _build_queue_perf(perf_name)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # aggregates have their own leaf lock: launch/finalize threads
        # bump error counters while holding a batch lock, and must not
        # contend with (or deadlock against) the pending-queue lock
        self._stats_lock = threading.Lock()
        self._pending: dict[tuple, list[_Sub]] = {}
        self._pending_bytes: dict[tuple, int] = {}
        self._deadline: float | None = None
        self._worker: threading.Thread | None = None
        self._closed = False
        self.created_at = time.time()
        self.launches = 0
        self.launched_runs = 0
        self.launched_bytes = 0
        self.launched_subs = 0
        self.pg_mix_total = 0
        self.cross_pg_launches = 0
        self.launch_retries = 0
        self.launch_errors = 0
        self.decode_launches = 0
        self.repair_launches = 0
        self.last_launch: dict | None = None

    # -- host singleton ------------------------------------------------------

    @classmethod
    def host_instance(cls, window_us: float | None = None,
                      max_bytes: int | None = None,
                      device: str | torch.device | None = None
                      ) -> "ECLaunchQueue":
        """The host's queue, built on first use (first caller's knobs
        win — one queue per host is the deployment contract)."""
        with cls._host_lock:
            if cls._host is None:
                kw = {}
                if window_us is not None:
                    kw["window_us"] = window_us
                if max_bytes is not None:
                    kw["max_bytes"] = max_bytes
                if device is not None:
                    kw["device"] = device
                cls._host = cls(**kw)
            return cls._host

    @classmethod
    def host_get(cls) -> "ECLaunchQueue | None":
        return cls._host

    @classmethod
    def reset_host(cls) -> None:
        """Tests only: close and drop the host queue (in-flight tickets
        of the old queue still resolve through their own references)."""
        with cls._host_lock:
            if cls._host is not None:
                cls._host.close()
            cls._host = None

    # -- submission ----------------------------------------------------------

    def submit_extents(self, plugin, runs: list[np.ndarray],
                       owner=None, traces=()) -> LaunchTicket:
        """Queue a drain's fused append runs (each (k, Wi) uint8) for a
        coalesced `encode_extents_with_crc_submit` launch; `result()`
        yields the per-run (parity, l, tail, body) tuples in this
        submission's run order.  traces: the contributing ops' trace
        ids (flight-recorder stitching)."""
        return self._submit("x", plugin, [
            np.ascontiguousarray(r, dtype=np.uint8) for r in runs],
            owner, traces=traces)

    def submit_chunks(self, plugin, chunks: np.ndarray,
                      owner=None, traces=()) -> LaunchTicket:
        """Queue a drain's concatenated plain (k, W) run for a coalesced
        parity-only launch; `result()` yields this submission's (m, W)
        parity columns."""
        return self._submit("c", plugin, [
            np.ascontiguousarray(chunks, dtype=np.uint8)], owner,
            traces=traces)

    def submit_decode(self, plugin, dense: np.ndarray, erasures,
                      owner=None, traces=()) -> LaunchTicket:
        """Queue one recovery/reconstruct decode: `dense` is the
        (k+m, W) array with zeros in the erased rows.  Submissions
        sharing (codec, erasure pattern) coalesce into one
        `decode_chunks` launch across PGs; `result()` yields this
        submission's decoded (k+m, W) columns."""
        erasures = tuple(sorted(int(e) for e in erasures))
        return self._submit(
            "d", plugin,
            [np.ascontiguousarray(dense, dtype=np.uint8)], owner,
            key_suffix=(erasures,), extra=erasures, traces=traces)

    def submit_clay_repair(self, plan, rows: np.ndarray,
                           owner=None, traces=()) -> LaunchTicket:
        """Queue one CLAY repair-plan apply: `rows` are the stacked
        helper repair-plane symbols (d*P, W) of one object (or a
        backend's own concatenation of several).  Submissions sharing a
        plan signature coalesce into one K4 launch
        (parallel/mesh.ClayRepairPlan); `result()` yields this
        submission's (sub_chunks, W) rebuilt columns."""
        return self._submit(
            "r", plan, [np.ascontiguousarray(rows, dtype=np.uint8)],
            owner, traces=traces)

    def _submit(self, kind: str, plugin, runs, owner,
                key_suffix: tuple = (), extra=None,
                traces=()) -> LaunchTicket:
        dev = getattr(plugin, "device", None)
        if dev is not None and torch.device(dev) != self.device:
            raise ValueError(f"{_codec_label(plugin)} runs on {dev}, the "
                             f"launch queue on {self.device}")
        if kind == "r":
            key = (kind,) + tuple(plugin.signature)
        else:
            key = (kind,) + codec_signature(plugin) + key_suffix
        ticket = LaunchTicket(self, kind, key)
        sub = _Sub(ticket, plugin, runs, owner, extra=extra,
                   traces=traces)
        batches: list[_Batch] = []
        with self._lock:
            self._pending.setdefault(key, []).append(sub)
            nb = self._pending_bytes.get(key, 0) + sub.nbytes
            self._pending_bytes[key] = nb
            if nb >= self.max_bytes or self.window_us <= 0:
                # occupancy cap reached (or batching disabled): launch
                # this key's super-batch immediately
                batches = self._pop_batches_locked(key)
            else:
                self._arm_window_locked()
        for batch in batches:
            self._do_launch(batch)
        return ticket

    def _cancel(self, ticket: LaunchTicket) -> None:
        with self._lock:
            subs = self._pending.get(ticket._key)
            if subs:
                for sub in subs:
                    if sub.ticket is ticket:
                        subs.remove(sub)
                        self._pending_bytes[ticket._key] -= sub.nbytes
                        if not subs:
                            del self._pending[ticket._key]
                            del self._pending_bytes[ticket._key]
                        if not self._pending:
                            self._deadline = None
                        break
        ticket.cancelled = True

    # -- window --------------------------------------------------------------

    def _arm_window_locked(self) -> None:
        """First pending submission of a window sets the deadline (a
        later submit never extends it) and wakes the single persistent
        window worker."""
        if self._deadline is None:
            self._deadline = time.perf_counter() + self.window_us / 1e6
            self._cv.notify()
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._window_loop, daemon=True,
                name="ec-launch-window")
            self._worker.start()

    def close(self) -> None:
        """Flush pending batches and retire the window worker (joined
        here, so no worker thread outlives a throwaway queue).  Tickets
        submitted after close still launch via byte cap or
        flush-on-demand; only the window stops firing."""
        self.flush()
        with self._lock:
            self._closed = True
            self._cv.notify()
            worker = self._worker
        if worker is not None and worker is not threading.current_thread():
            worker.join()

    def _window_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                if self._deadline is None:
                    self._cv.wait()
                    continue
                delay = self._deadline - time.perf_counter()
                if delay > 0:
                    self._cv.wait(delay)
                    continue
                batches = [b for k in list(self._pending)
                           if self._pending.get(k)
                           for b in self._pop_batches_locked(k)]
                self._deadline = None
            for batch in batches:
                self._do_launch(batch)

    def flush(self, key: tuple | None = None) -> None:
        """Launch pending super-batches now (all keys, or one)."""
        with self._lock:
            keys = [key] if key is not None else list(self._pending)
            batches = [b for k in keys if self._pending.get(k)
                       for b in self._pop_batches_locked(k)]
        for batch in batches:
            self._do_launch(batch)

    # -- launch --------------------------------------------------------------

    def _pop_batches_locked(self, key: tuple) -> "list[_Batch]":
        """Under self._lock: claim a key's pending submissions as one
        or more batches, binding every ticket to one.  Decode keys
        split at DECODE_MAX_LAUNCH_W of summed input width.  The device
        submit itself happens OUTSIDE the queue lock in _do_launch."""
        subs = self._pending.pop(key)
        self._pending_bytes.pop(key, None)
        if not self._pending:
            self._deadline = None
        if key[0] != "d":
            groups = [subs]
        else:
            groups, cur, cur_w = [], [], 0
            for s in subs:
                w = int(s.runs[0].shape[1])
                if cur and cur_w + w > DECODE_MAX_LAUNCH_W:
                    groups.append(cur)
                    cur, cur_w = [], 0
                cur.append(s)
                cur_w += w
            if cur:
                groups.append(cur)
        return [self._make_batch_locked(key, g) for g in groups]

    def _make_batch_locked(self, key: tuple,
                           subs: "list[_Sub]") -> _Batch:
        batch = _Batch(key[0], subs)
        now = time.perf_counter()
        for s in subs:
            s.ticket._batch = batch
            if self.perf:
                self.perf.hinc("lat_ec_batch_wait", now - s.t_submit)
        batch.queue_wait = now - min(s.t_submit for s in subs)
        nbytes = sum(s.nbytes for s in subs)
        nruns = sum(s.n_runs for s in subs)
        owners = {s.owner for s in subs}
        occupancy = min(100.0, 100.0 * nbytes / self.max_bytes)
        with self._stats_lock:
            self.launches += 1
            self.launched_runs += nruns
            self.launched_bytes += nbytes
            self.launched_subs += len(subs)
            self.pg_mix_total += len(owners)
            if len(owners) > 1:
                self.cross_pg_launches += 1
            if batch.kind == "d":
                self.decode_launches += 1
            elif batch.kind == "r":
                self.repair_launches += 1
            self.last_launch = {"runs": nruns, "bytes": nbytes,
                                "submissions": len(subs),
                                "pg_mix": len(owners),
                                "occupancy_pct": round(occupancy, 2)}
        if self.perf:
            self.perf.inc("ec_host_launches")
            self.perf.inc("ec_host_launch_runs", nruns)
            self.perf.inc("ec_host_launch_bytes", nbytes)
            self.perf.inc("ec_host_launch_pg_mix", len(owners))
            if len(owners) > 1:
                self.perf.inc("ec_host_cross_pg_launches")
            if batch.kind == "d":
                self.perf.inc("ec_host_decode_launches")
            elif batch.kind == "r":
                self.perf.inc("ec_host_repair_launches")
            self.perf.set("ec_host_occupancy_pct", round(occupancy, 2))
        return batch

    def _note_launch_error(self) -> None:
        with self._stats_lock:
            self.launch_errors += 1
        if self.perf:
            self.perf.inc("ec_host_launch_errors")

    def _on_device(self):
        """The launching thread's device context: the current card is
        per thread, and a worker thread starts on card 0."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @staticmethod
    def _launch(kind: str, plugin, big: np.ndarray, extra):
        """One device entry for one kind over (concatenated) columns;
        the same entry serves the combined launch and the
        per-submission re-issue."""
        if kind == "r":
            return ("np", np.asarray(plugin.apply(big)))
        if kind == "d":
            return ("np", np.asarray(plugin.decode_chunks(
                big, list(extra))))
        if hasattr(plugin, "encode_chunks_submit"):
            return ("h", plugin.encode_chunks_submit(big))
        # host-synchronous CPU plugins: one concatenated encode
        return ("np", np.asarray(plugin.encode_chunks(big)))

    def _do_launch(self, batch: _Batch) -> None:
        if not batch._launch_claim.acquire(blocking=False):
            # another thread owns the submit; it sets launch_done
            return
        subs = batch.subs
        kind = batch.kind
        prof = device_profiler()
        rec = prof.begin(
            {"x": "fused_encode", "c": "plain_encode",
             "d": "decode", "r": "clay_repair"}[kind],
            codec=_codec_label(subs[0].plugin),
            runs=sum(s.n_runs for s in subs),
            nbytes=sum(s.nbytes for s in subs),
            pg_mix=len({s.owner for s in subs}),
            traces=[t for s in subs for t in s.traces],
            queue_wait_s=batch.queue_wait)
        try:
            with self._on_device():
                plugin = subs[0].plugin
                if kind == "x":
                    handle = plugin.encode_extents_with_crc_submit(
                        [r for s in subs for r in s.runs])
                    batch.path = handle.get("path")
                    bucket = _extents_bucket(handle)
                else:
                    bigs = [s.runs[0] for s in subs]
                    big = np.concatenate(bigs, axis=1) \
                        if len(bigs) > 1 else bigs[0]
                    handle = self._launch(kind, plugin, big,
                                          subs[0].extra)
                    if kind == "r":
                        sig = abs(hash(tuple(plugin.signature))) \
                            & 0xFFFFFF
                        bucket = f"r:{sig:x}:w{big.shape[1]}"
                    elif kind == "d":
                        era = "".join(str(e) for e in subs[0].extra)
                        bucket = f"d:e{era}:w{big.shape[1]}"
                    else:
                        bucket = f"c:{handle[0]}:w{big.shape[1]}"
        except Exception:  # noqa: BLE001 — containment re-issue
            # a poison submission must fail only its owner: re-issue
            # each submission through the same entry on its OWN
            # plugin, recording per-ticket errors
            with self._stats_lock:
                self.launch_retries += 1
            if self.perf:
                self.perf.inc("ec_host_launch_retries")
            batch.per_sub = []
            with self._on_device():
                for s in subs:
                    try:
                        if kind == "x":
                            h = s.plugin.encode_extents_with_crc_submit(
                                s.runs)
                        else:
                            h = self._launch(kind, s.plugin, s.runs[0],
                                             s.extra)
                        batch.per_sub.append((s, h))
                    except Exception as e:  # noqa: BLE001 — the poison sub
                        self._note_launch_error()
                        s.ticket._error = LaunchQueueError(
                            f"launch failed for this submission: {e!r}")
                        s.ticket._error.__cause__ = e
                        s.ticket._done = True
                        batch.per_sub.append((s, None))
        else:
            batch.combined = (plugin, handle)
            # a launch with a kernel behind it: the fused and plain
            # device entries, and plugins or plans with a device
            kernel = kind == "x" or handle[0] == "h" or \
                getattr(plugin, "device", None) is not None
            prof.submitted(rec, bucket,
                           path=batch.path if kind == "x" else handle[0],
                           jit=kernel)
            batch.prof_rec = rec
            if rec is not None:
                for s in subs:
                    t = s.ticket
                    t.launch_id = rec.launch_id
                    t.bucket = rec.bucket
                    t.compiled = rec.compiled
                    t.compile_s = rec.compile_s
                    t.cache_hit = rec.cache_hit
        finally:
            for s in subs:
                s.runs = None   # the launch holds the staged arrays now
            batch.launch_done.set()

    # -- finalize ------------------------------------------------------------

    def _finalize_batch(self, batch: _Batch) -> None:
        """Materialize one super-batch ONCE and demultiplex each
        submission's share onto its ticket; errors are memoized so every
        co-batched ticket sees the same outcome.  Runs on the first
        finalizing backend's thread."""
        if not batch.launch_done.is_set():
            # steal the launch if the window worker hasn't started it
            self._do_launch(batch)
        batch.launch_done.wait()
        with batch.lock:
            if batch.finalized:
                return
            t_mat = time.perf_counter()
            try:
                if batch.per_sub is not None:
                    for sub, handle in batch.per_sub:
                        if handle is None:
                            continue        # launch already failed
                        try:
                            self._finalize_sub(batch.kind, sub, handle)
                        except Exception as e:  # noqa: BLE001
                            self._note_launch_error()
                            sub.ticket._error = e
                            sub.ticket._done = True
                else:
                    plugin, handle = batch.combined
                    if batch.kind == "x":
                        res = plugin.encode_extents_with_crc_finalize(
                            handle)
                        pos = 0
                        for sub in batch.subs:
                            sub.ticket._result = \
                                res[pos:pos + sub.n_runs]
                            sub.ticket.path = batch.path
                            sub.ticket._done = True
                            pos += sub.n_runs
                    else:
                        kind_h, h = handle
                        par = plugin.encode_chunks_finalize(h) \
                            if kind_h == "h" else h
                        col = 0
                        for sub in batch.subs:
                            sub.ticket._result = \
                                par[:, col:col + sub.width]
                            sub.ticket._done = True
                            col += sub.width
            except Exception as e:  # noqa: BLE001 — device finalize
                # died: every ticket of the batch carries the error;
                # each backend aborts ITS ops and the queue lives on
                for sub in batch.subs:
                    if not sub.ticket._done:
                        self._note_launch_error()
                        sub.ticket._error = e
                        sub.ticket._done = True
            finally:
                batch.finalized = True
                device_profiler().materialized(
                    batch.prof_rec, time.perf_counter() - t_mat)

    def _finalize_sub(self, kind: str, sub: _Sub, handle) -> None:
        if kind == "x":
            sub.ticket._result = \
                sub.plugin.encode_extents_with_crc_finalize(handle)
            sub.ticket.path = handle.get("path")
        else:
            kind_h, h = handle
            sub.ticket._result = sub.plugin.encode_chunks_finalize(h) \
                if kind_h == "h" else h
        sub.ticket._done = True

    # -- observability -------------------------------------------------------

    def status(self) -> dict:
        """Batching knobs, launch/coalescing/occupancy aggregates and
        the pending backlog."""
        with self._lock:
            pending_subs = sum(len(v) for v in self._pending.values())
            pending_bytes = sum(self._pending_bytes.values())
        with self._stats_lock:
            launches = self.launches
            return {
                "device": str(self.device),
                "window_us": self.window_us,
                "max_super_batch_bytes": self.max_bytes,
                "launches": launches,
                "coalesced_runs": self.launched_runs,
                "coalesced_bytes": self.launched_bytes,
                "submissions": self.launched_subs,
                "avg_runs_per_launch": round(
                    self.launched_runs / launches, 2)
                if launches else 0.0,
                "occupancy_pct_avg": round(min(
                    100.0, 100.0 * self.launched_bytes
                    / (launches * self.max_bytes)), 2)
                if launches else 0.0,
                "cross_pg_launches": self.cross_pg_launches,
                "pg_mix_avg": round(
                    self.pg_mix_total / launches, 2)
                if launches else 0.0,
                "launch_retries": self.launch_retries,
                "launch_errors": self.launch_errors,
                "decode_launches": self.decode_launches,
                "repair_launches": self.repair_launches,
                "last_launch": self.last_launch,
                "pending_submissions": pending_subs,
                "pending_bytes": pending_bytes,
                "uptime_s": round(time.time() - self.created_at, 1),
            }

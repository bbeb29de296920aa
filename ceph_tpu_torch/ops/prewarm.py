"""Boot-time prewarm: run the expected launch buckets before `up`.

The port of ceph_tpu/ops/prewarm.py.  The plan does not predict what to
warm: it executes the same plugin entry points the launch queue and the
backend's direct paths call (`encode_extents_with_crc_submit` /
`_finalize`, `encode_chunks_submit` / `_finalize`, `decode_chunks`)
with zero runs of the planned geometry, and reads the bucket label back
from the live submit handle, so a prewarmed bucket matches the runtime
bucket by construction.  Every warmed bucket is pre-seeded into the
flight recorder (DeviceProfiler.note_prewarm), so its first runtime
launch is not first-seen.

What a prewarm warms on the card (ops/compile_cache.py says what
"compile" means there): the kernel library's build or load, the CUDA
context, each kernel's lazy module load at its first launch (K1 for the
plain encode and the decodes, K2 or K3 for the fused entries at the
plugin's operating point), the autotuned point itself (the first fused
entry resolves it), the decode tables of the planned erasure sets, and
the pinned host blocks of the planned widths (PyTorch's caching host
allocator keeps a freed pinned block for the next request of its size).
Nothing compiles per shape, so a width the plan does not name still
runs on warm kernels; only its pinned block is new.

Differences from the reference:

* No `aot_compile_*` hooks: the reference's plugin compiled each
  covered shape ahead of time behind a `hasattr` guard; the torch
  plugin has nothing to compile per shape, so the guard is gone.
* Bucket labels are the port's: exact widths, not power-of-two buckets
  (`parallel/launch_queue._extents_bucket` for fused launches,
  `c:{kind}:w{W}` and `d:e{erasures}:w{W}` for the others).  The
  reference's default widths stop at 64 KiB; a caller whose writes or
  recoveries stage wider buffers names those widths through the
  `widths`, `plain_widths` and `decode_widths` arguments.
* An entry is `compiled` when it ran an nvcc build of the kernel
  library in this process (`_build.build_count()` moved), else a
  `cache_hit`.

Bounded: `budget_s` (conf osd_ec_prewarm_budget_s) caps the wall the
boot may spend here; a cutoff marks the plan truncated and the daemon
boots with whatever was warmed.  An entry that fails counts as
`skipped` and does not fail the boot; nothing runs in its place.
Entries run cheapest-first so a tight budget still covers the small
buckets.
"""

from __future__ import annotations

import threading
import time
from itertools import combinations

import numpy as np

from . import _build, compile_cache

# one prewarm per process: in-process clusters boot many OSDs into one
# interpreter, but what is warmed (the library, the context, the
# modules, the pinned blocks) is process-wide
_guard_lock = threading.Lock()
_ran = False
_last_status: dict | None = None


def _predict_extents(run_ws, tile=None, wb=None, combine="xla",
                     use_w32=True) -> str:
    """The bucket label ops/bitsliced.gf_encode_extents_with_crc_submit
    gives runs of widths `run_ws` at an operating point, as
    parallel/launch_queue._extents_bucket spells it."""
    from .bitsliced import FUSED_TILE, FUSED_TILE_HIER, FUSED_WB
    tile_hier = tile or FUSED_TILE_HIER
    wb = wb or FUSED_WB
    big = [w for w in run_ws if use_w32 and w >= tile_hier]
    if 0 < len(big) < len(run_ws):
        small = [w for w in run_ws if w < tile_hier]
        return "+".join(_predict_extents(part, tile, wb, combine)
                        for part in (big, small))
    hier = len(big) == len(run_ws)
    block = 4 * wb if hier else FUSED_TILE
    if hier:
        path = "hier_acc" if combine == "kernel" else "hier_lsub"
    else:
        path = "w32_flat" if use_w32 else "bytes"
    width = sum(w + (-w % block) for w in run_ws)
    return f"x:{path}:w{width}:r{len(run_ws)}"


class PrewarmPlan:
    """Ordered prewarm entries for one codec.

    widths: total fused-drain byte widths; for each, every run count r
    with W/r >= the flat fused tile is an entry (r runs of W/r bytes —
    the depth-r pipelined write-storm shape).  plain_widths: plain
    (no-crc) encode widths.  decode_widths x decode_erasures:
    recovery/reconstruct shapes.
    """

    def __init__(self, plugin, widths=None, run_counts=None,
                 plain_widths=None, decode_widths=None,
                 decode_erasures=None, budget_s: float = 8.0,
                 profiler=None):
        from .bitsliced import FUSED_TILE
        self.plugin = plugin
        self.budget_s = float(budget_s)
        self.profiler = profiler
        tile = FUSED_TILE
        if widths is None:
            widths = [tile << j for j in range(5)]     # 2K..32K
        if run_counts is None:
            run_counts = [1, 2, 4]
        if plain_widths is None:
            plain_widths = [2048 << j for j in range(4)]
        if decode_widths is None:
            # up to ECBackend.DECODE_MAX_LAUNCH_W, the grouped recovery
            # decode's launch width cap
            decode_widths = [2048 << j for j in range(6)]   # 2K..64K
        if decode_erasures is None:
            # one representative per erasure cardinality, for every
            # cardinality up to m: _buckets_of seeds the whole
            # combination class from one execution
            m = (plugin.get_chunk_count()
                 - plugin.get_data_chunk_count())
            decode_erasures = [tuple(range(c))
                               for c in range(1, max(1, m) + 1)]
        # entries: ("x", run_widths) | ("c", width) | ("d", width, erasures)
        entries: list[tuple] = []
        for w in sorted(set(plain_widths)):
            entries.append(("c", int(w)))
        for w, era in [(w, e) for w in sorted(set(decode_widths))
                       for e in decode_erasures]:
            entries.append(("d", int(w), tuple(era)))
        for w in sorted(set(widths)):
            for r in sorted(set(run_counts)):
                if r >= 1 and w % r == 0 and w // r >= tile:
                    entries.append(("x", (int(w // r),) * int(r)))
                elif r == 1:
                    entries.append(("x", (int(w),)))
        self.entries = entries
        self.status: dict = {
            "planned": len(entries), "done": 0, "skipped": 0,
            "truncated": False, "total_s": 0.0, "budget_s": self.budget_s,
            "compiles": 0, "cache_hits": 0, "buckets": [],
        }

    # -- plan prediction (for tests / status, no execution) -------------

    def planned_buckets(self) -> list[str]:
        """Bucket labels this plan will seed, computed without running
        it: the fused labels from the entry widths at the plugin's
        operating point."""
        out = []
        for e in self.entries:
            out.extend(self._buckets_of(e, None))
        return out

    def _buckets_of(self, entry, handle) -> list[str]:
        """Bucket labels one entry covers.  With a live submit handle
        the fused label comes from the handle, as the queue reads it;
        without one it is predicted from the entry geometry."""
        plugin = self.plugin
        kind = entry[0]
        if kind == "x":
            from ..parallel.launch_queue import _extents_bucket
            if handle is not None:
                return [_extents_bucket(handle)]
            point = plugin._point_kwargs() \
                if hasattr(plugin, "_point_kwargs") else {}
            return [_predict_extents(entry[1], **point)]
        if kind == "c":
            w = entry[1]
            if hasattr(plugin, "encode_chunks_submit"):
                # the torch plugin tags its plain-encode handle "torch":
                # the direct backend path labels by it, the launch
                # queue by its own ("h", ...) wrapper
                sub_kind = handle[0] if handle is not None else "torch"
                return [f"c:{sub_kind}:w{w}", f"c:h:w{w}"]
            return [f"c:np:w{w}"]
        w, era = entry[1], entry[2]
        # the executed pattern stands in for its whole cardinality class
        # (same kernel, tables of the same shape): seed every pattern
        # label of that cardinality
        n = plugin.get_chunk_count()
        return [f"d:e{''.join(str(i) for i in c)}:w{w}"
                for c in combinations(range(n), len(era))]

    # -- execution ------------------------------------------------------

    def _run_entry(self, entry):
        """Execute one entry's real plugin calls (finalize waits for
        the card) and return the live submit handle or None."""
        plugin = self.plugin
        k = plugin.get_data_chunk_count()
        kind = entry[0]
        if kind == "x" and hasattr(plugin,
                                   "encode_extents_with_crc_submit"):
            runs = [np.zeros((k, w), dtype=np.uint8) for w in entry[1]]
            handle = plugin.encode_extents_with_crc_submit(runs)
            plugin.encode_extents_with_crc_finalize(handle)
            return handle
        if kind == "c":
            chunks = np.zeros((k, entry[1]), dtype=np.uint8)
            if hasattr(plugin, "encode_chunks_submit"):
                h = plugin.encode_chunks_submit(chunks)
                plugin.encode_chunks_finalize(h)
                return h
            plugin.encode_chunks(chunks)
            return None
        if kind == "d":
            w, era = entry[1], entry[2]
            dense = np.zeros((plugin.get_chunk_count(), w), dtype=np.uint8)
            plugin.decode_chunks(dense, list(era))
        return None

    def run(self) -> dict:
        """Execute the plan within budget; returns (and stores) the
        `prewarm status` dict.  Failures of individual entries are
        counted and skipped — prewarm must never fail a boot."""
        t0 = time.perf_counter()
        st = self.status
        for entry in self.entries:
            if time.perf_counter() - t0 >= self.budget_s:
                st["truncated"] = True
                st["skipped"] = st["planned"] - st["done"]
                break
            builds0 = _build.build_count()
            te = time.perf_counter()
            try:
                handle = self._run_entry(entry)
            except Exception:  # noqa: BLE001 — warm what we can
                st["skipped"] += 1
                continue
            warm_s = time.perf_counter() - te
            cache_hit = _build.build_count() == builds0
            for b in self._buckets_of(entry, handle):
                if self.profiler is not None:
                    self.profiler.note_prewarm(b, warm_s, cache_hit)
                st["buckets"].append(b)
            st["done"] += 1
            st["cache_hits" if cache_hit else "compiles"] += 1
        st["total_s"] = round(time.perf_counter() - t0, 3)
        st["persistent_cache"] = compile_cache.status()
        return st


def run_once(plugin, profiler=None, budget_s: float = 8.0,
             **plan_kwargs) -> dict:
    """Process-level prewarm entry (OSD boot): the first caller runs
    the plan, later callers (more in-process daemons) get the stored
    status back — what it warms is process-wide."""
    global _ran, _last_status
    with _guard_lock:
        if _ran:
            return dict(_last_status or {}, reused=True)
        _ran = True
    plan = PrewarmPlan(plugin, budget_s=budget_s, profiler=profiler,
                       **plan_kwargs)
    status = plan.run()
    with _guard_lock:
        _last_status = status
    return status


def last_status() -> dict | None:
    return _last_status


def reset_for_tests() -> None:
    """Tests only: allow another run_once."""
    global _ran, _last_status
    with _guard_lock:
        _ran = False
        _last_status = None

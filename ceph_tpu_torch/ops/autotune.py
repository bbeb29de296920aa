"""Cached autotuner for the fused parity+crc write path's operating point.

The port of ceph_tpu/ops/autotune.py.  A point keeps the JAX keys
(tile, wb, extract, combine) so points and cache rows read alike, but
only the axes that change a CUDA launch are swept:

  * `wb` — the hier crc block in 4-byte words (256, 512, 1024: blocks
    of 1, 2 and 4 KiB).  It sets K2/K3's thread-block count and shared
    memory per block, K3's walk shape (2 KiB takes the scrub block's
    layout), and the depth of the per-run fold;
  * `combine` — "xla": K2 (per-block L) then one combine_crcs_pow2
    chain of small launches per run; "kernel": K3 folds every run's L
    inside the launch (csrc/gf_encode_crc_acc.cu).

`extract` (a Mosaic bit-extraction variant, no counterpart in a
table-lookup kernel) stays "planar" and `tile` stays FUSED_TILE_HIER
(the hier threshold): the kernels' block is 4*wb whatever the tile.

  * the sweep runs at plugin init (first fused encode) on a CUDA device
    only — a CPU device gets the default point unless the caller asks
    for the sweep (`sweep_on_cpu`, the tests' and the sweep CLI's
    --validate-only gate);
  * every candidate is first VALIDATED bit-exactly against the host
    parity (gf_matvec) and crc32c, so a variant that computes a wrong
    byte or crc is reported None and never cached.  A kernel that does
    not build or launch raises out of the sweep: no point is picked
    around a broken kernel;
  * results persist in a JSON cache (version 2) keyed by
    cuda/<device name>/sm<major><minor>/torch<version>/<KERNEL_GEN>/k<k>m<m>,
    so only the first init on a given card and software stack sweeps;
  * a wall-clock budget (CEPH_TPU_AUTOTUNE_BUDGET_S, default 75 s)
    bounds init latency; candidates are ordered best-guess-first (the
    cached winner of the nearest key of this device, then the static
    default) and the sweep keeps the best measured point.

Env knobs (the JAX names): CEPH_TPU_AUTOTUNE=0 disables sweeping (cache
hits are still honoured); CEPH_TPU_AUTOTUNE_CACHE overrides the cache
path (default ~/.cache/ceph_tpu_torch/autotune.json).
"""

from __future__ import annotations

import json
import os
import platform
import statistics
import threading
import time
from pathlib import Path

import numpy as np
import torch

SWEEP_WBS = (256, 512, 1024)
SWEEP_COMBINES = ("xla", "kernel")

# measurement input: bytes per shard — one 4 MiB object at k=8 (the
# write path's run); calls timed per candidate
MEASURE_BYTES = 1 << 19
MEASURE_CALLS = 20

# the cache's kernel-generation tag: bumped when K2/K3 change shape, so
# winners measured under older kernels never satisfy a lookup (they
# still seed the sweep's ordering)
KERNEL_GEN = "cuda_k2k3r3"

_lock = threading.Lock()


def default_point() -> dict:
    """The static point: the hier threshold and 2 KiB crc blocks with
    K3's in-kernel fold — the point the sweep picks on an H100 (the
    K2 + fold combine loses there by its per-run launches; PERF.md)."""
    from . import bitsliced as bs
    return {"tile": bs.FUSED_TILE_HIER, "wb": bs.FUSED_WB,
            "extract": "planar", "combine": "kernel"}


def _cache_path() -> Path:
    env = os.environ.get("CEPH_TPU_AUTOTUNE_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "ceph_tpu_torch" / "autotune.json"


def _load_cache() -> dict:
    try:
        data = json.loads(_cache_path().read_text())
    except (OSError, ValueError):
        return {"version": 2, "entries": {}}
    if not isinstance(data, dict) or data.get("version") != 2:
        return {"version": 2, "entries": {}}
    return data


def _save_cache(data: dict) -> None:
    """Atomic, best-effort: a read-only home dir must not break init."""
    try:
        path = _cache_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(data, indent=1, sort_keys=True))
        os.replace(tmp, path)
    except OSError:
        pass


def _device_prefix(device: torch.device) -> str:
    if device.type == "cuda":
        maj, mnr = torch.cuda.get_device_capability(device)
        return (f"cuda/{torch.cuda.get_device_name(device)}"
                f"/sm{maj}{mnr}/")
    return f"cpu/{platform.machine() or 'cpu'}/"


def _device_key(device: torch.device, k: int, m: int) -> str:
    # the torch version is part of the key: a point validated on one
    # stack is re-swept after an upgrade
    return (f"{_device_prefix(device)}torch{torch.__version__}"
            f"/{KERNEL_GEN}/k{k}m{m}")


def _nearest_point(cache: dict, device: torch.device) -> dict | None:
    """Seed for a cold key: the cached winner whose key shares this
    device's prefix — any geometry, torch version or kernel generation,
    preferring the same torch version, then the same generation, then
    the fastest.  Seeds only ORDER candidates; every one validates."""
    prefix = _device_prefix(device)
    ver_tag = f"/torch{torch.__version__}/"
    best, best_rank = None, None
    for key, ent in cache.get("entries", {}).items():
        if not key.startswith(prefix):
            continue
        point = {kk: ent.get(kk) for kk in
                 ("tile", "wb", "extract", "combine")}
        if point["tile"] is None or point["wb"] is None:
            continue
        rank = (ver_tag not in key, f"/{KERNEL_GEN}/" not in key,
                -float(ent.get("gbps") or 0.0))
        if best_rank is None or rank < best_rank:
            best, best_rank = point, rank
    return best


def _legal(k: int, m: int, wb: int) -> bool:
    """The hier kernels need a block (4*wb bytes) that is a multiple of
    128 and fits one thread block's shared memory."""
    from . import bitsliced as bs
    block = 4 * wb
    if wb <= 0 or block % 128:
        return False
    try:
        bs._crc_smem_bytes(m, k, block)
        bs.k3_smem(m, k, block)
    except ValueError:
        return False
    return True


def candidates(k: int, m: int, wbs=None, seed: dict | None = None
               ) -> list[dict]:
    """Legal points, best-guess-first: the `seed` point (a cached
    neighbour's winner) leads when given, then the static default, then
    the seed's wb neighbourhood, then the rest."""
    from . import bitsliced as bs
    out = [{"tile": bs.FUSED_TILE_HIER, "wb": wb, "extract": "planar",
            "combine": combine}
           for wb in (wbs or SWEEP_WBS) if _legal(k, m, wb)
           for combine in SWEEP_COMBINES]
    dflt = default_point()

    def _match(c: dict, p: dict | None) -> bool:
        return p is not None and all(c[kk] == p.get(kk) for kk in c)

    out.sort(key=lambda c: (
        not _match(c, seed),
        not _match(c, dflt),
        seed is None or c["wb"] != seed.get("wb"),
        c["wb"] != dflt["wb"], c["combine"] != dflt["combine"]))
    return out


def _validate(tables: torch.Tensor, mat: np.ndarray, cand: dict) -> bool:
    """Bit-exactness gate: ONE launch of TWO runs at the candidate's wb
    and combine — each run spans at least three crc blocks (the
    cross-block fold), one has an odd tail (the front pad, or the host
    tail fold) — against the host GF(2^8) parity and crc32c of every
    shard of each run.  A wrong byte or crc rejects the candidate; a
    kernel that fails to build or launch raises."""
    from ..common import crc32c as _crc
    from ..ec import gf
    from . import bitsliced as bs
    from . import crc32c_linear as cl
    m_, k = mat.shape
    wb = cand["wb"]
    block = 4 * wb
    rng = np.random.default_rng(0xC5C)
    runs = [rng.integers(0, 256, (k, w), dtype=np.uint8)
            for w in (3 * block, 4 * block + 7)]
    handle = bs.gf_encode_extents_with_crc_submit(
        tables, runs, tile=block, wb=wb, combine=cand["combine"])
    want_path = "hier_acc" if cand["combine"] == "kernel" else "hier_lsub"
    if handle["path"] != want_path:
        return False
    results = bs.gf_encode_extents_with_crc_finalize(handle)
    for run, (par, l, tail, body) in zip(runs, results):
        if not np.array_equal(par, gf.gf_matvec(mat, run)):
            return False
        allsh = np.concatenate([run, par], axis=0)
        for s in range(k + m_):
            if cl.fold_run_crc(int(l[s]), body, 0xFFFFFFFF,
                               tail[s].tobytes()) != \
                    _crc.crc32c(allsh[s].tobytes(), 0xFFFFFFFF):
                return False
    return True


def _measure(tables: torch.Tensor, k: int, m: int, cand: dict) -> float:
    """Input bytes/s of one gf_encode_with_crc_w32_fold call at the
    candidate's point on (k, MEASURE_BYTES): the median of
    MEASURE_CALLS calls, each between a pair of CUDA events, the host's
    launch gaps included — the "xla" combine's cost is its launches,
    and a drain pays them."""
    from . import bitsliced as bs
    dev = tables.device
    rng = np.random.default_rng(0x7E5)
    data = torch.from_numpy(
        rng.integers(0, 256, (k, MEASURE_BYTES), dtype=np.uint8)).to(dev)

    def call():
        bs.gf_encode_with_crc_w32_fold(tables, data, cand["wb"],
                                       cand["combine"])
    call()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(MEASURE_CALLS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(MEASURE_CALLS):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return k * MEASURE_BYTES / dt if dt > 0 else 0.0


def fused_operating_point(k: int, m: int, tables: torch.Tensor | None = None,
                          mat: np.ndarray | None = None, wbs=None,
                          force: bool = False, report: list | None = None,
                          sweep_on_cpu: bool = False) -> dict:
    """The (tile, wb, extract, combine) point the fused encode+crc path
    runs at on the device of `tables`, sweeping and caching on first
    use.

    `tables` ((m, k, 256) product tables on the device) and `mat` ((m,
    k) GF(2^8) generator rows) enable the sweep; without them, with
    CEPH_TPU_AUTOTUNE=0, or on a CPU device (unless `sweep_on_cpu`) the
    cached or default point is returned as is.  `report`, when given,
    collects (cand, bytes/s | None) per candidate tried; `force`
    re-sweeps past a cache hit."""
    device = tables.device if tables is not None else torch.device("cpu")
    if device.type == "cpu" and not sweep_on_cpu:
        return default_point()
    with _lock:
        key = _device_key(device, k, m)
        cache = _load_cache()
        hit = cache["entries"].get(key)
        if hit is not None and not force:
            return {kk: hit[kk]
                    for kk in ("tile", "wb", "extract", "combine")}
        if os.environ.get("CEPH_TPU_AUTOTUNE", "1") == "0" or \
                tables is None or mat is None:
            return default_point()
        budget = float(os.environ.get("CEPH_TPU_AUTOTUNE_BUDGET_S", "75"))
        seed = _nearest_point(cache, device)
        t0 = time.perf_counter()
        best, best_rate = None, 0.0
        tried = 0
        for cand in candidates(k, m, wbs, seed=seed):
            # the budget binds once any candidate has been tried
            if tried and time.perf_counter() - t0 > budget:
                break
            tried += 1
            if not _validate(tables, mat, cand):
                if report is not None:
                    report.append((cand, None))
                continue
            rate = _measure(tables, k, m, cand)
            if report is not None:
                report.append((cand, rate))
            if rate > best_rate:
                best, best_rate = cand, rate
        if best is None:
            # every candidate computed wrong bytes or crcs: no point is
            # safe to write with, and none is cached
            raise RuntimeError(f"autotune: no fused operating point of "
                               f"k={k} m={m} is bit-exact on {device}")
        cache["entries"][key] = {**best,
                                 "gbps": round(best_rate / 1e9, 3),
                                 "when": time.strftime(
                                     "%Y-%m-%dT%H:%M:%S")}
        _save_cache(cache)
        return best

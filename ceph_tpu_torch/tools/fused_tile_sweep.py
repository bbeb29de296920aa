"""Sweep CLI for the fused parity+crc write path's operating point.

The port of ceph_tpu/tools/fused_tile_sweep.py.  The machinery lives in
ops/autotune.py, which the torch plugin consults at its first fused
encode (validated, measured, cached per card).  This CLI drives the
same sweep explicitly, prints the per-candidate table and refreshes the
cache — to see WHY the plugin picked its point, or to re-tune after a
CUDA stack or card change.

Usage: python -m ceph_tpu_torch.tools.fused_tile_sweep
           [-P device=cpu|cuda] [--keep-cache | --validate-only] [wbs...]

By default the sweep is forced (the cache row is refreshed); pass
--keep-cache to only print the cached point.  Candidates that fail the
bit-exactness validation print as INVALID.

--validate-only runs ONLY the bit-exactness gate over every candidate
(no measurement, no cache writes) and exits non-zero on any invalid
one.  On a CPU device (`-P device=cpu`) it validates through the plain
PyTorch versions; on the card, through K2 and K3.
"""

from __future__ import annotations

import sys

from ..ec.registry import ErasureCodePluginRegistry
from ..ops import autotune

K, M = 8, 3


def _cand_tag(cand: dict) -> str:
    return f"wb={cand['wb']:5d} combine={cand['combine']:6s}"


def validate_only(codec, wbs) -> int:
    print(f"# validate-only on {codec.device}: every candidate must stay "
          "bit-exact vs gf_matvec + host crc32c")
    bad = []
    cands = autotune.candidates(K, M, wbs=wbs)
    for cand in cands:
        ok = autotune._validate(codec._enc_tables, codec.matrix[K:], cand)
        print(f"{_cand_tag(cand)}  "
              f"{'ok' if ok else 'INVALID (failed bit-exactness)'}")
        if not ok:
            bad.append(cand)
    if bad:
        print(f"# {len(bad)}/{len(cands)} candidates INVALID")
        return 1
    print(f"# all {len(cands)} candidates bit-exact")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    profile = {"k": str(K), "m": str(M), "technique": "cauchy"}
    flags, wbs = set(), []
    while argv:
        a = argv.pop(0)
        if a in ("-P", "--parameter") and argv:
            key, _, val = argv.pop(0).partition("=")
            profile[key] = val
        elif a in ("--keep-cache", "--validate-only"):
            flags.add(a)
        elif a.isdigit():
            wbs.append(int(a))
        else:
            print(f"unknown option {a!r}.  Usage: fused_tile_sweep "
                  "[-P device=cpu|cuda] [--keep-cache | --validate-only] "
                  "[wbs...]", file=sys.stderr)
            return 2
    codec = ErasureCodePluginRegistry.instance().factory("torch", profile)
    if "--validate-only" in flags:
        return validate_only(codec, wbs or None)
    if codec.device.type == "cpu":
        print("device is cpu: the sweep measures the card's kernels; "
              f"static default point = {autotune.default_point()} "
              "(use --validate-only for the bit-exactness gate)")
        return 0
    if "--keep-cache" in flags:
        print(f"cached/current point: {codec.fused_point()}")
        print(f"cache file: {autotune._cache_path()}")
        return 0
    report: list = []
    best = autotune.fused_operating_point(
        K, M, tables=codec._enc_tables, mat=codec.matrix[K:],
        wbs=wbs or None, force=True, report=report)
    for cand, rate in report:
        if rate is None:
            print(f"{_cand_tag(cand)}  INVALID (failed bit-exactness)")
        else:
            print(f"{_cand_tag(cand)}  {rate / 1e9:7.2f} GB/s")
    print(f"best: {best}")
    print(f"cache file: {autotune._cache_path()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

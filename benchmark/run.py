#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 benchmark/run.py --workload k8m3-encode-4m --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout.  Earlier lines of standard output say the
operating point and the seconds at which set-up passed its stages;
the last is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1
its per-layer ones), `device`, with --trace 1 `breakdown`, and last
`checks`, each number the comparison with the reference compared,
beside its limit.  Standard error ends with the same checks.

Without a CUDA card, or with fewer cards than the cell asks for, the
run exits 2 and prints no result; a run whose process has loaded JAX or
the JAX package exits 3.  Caches (the autotuner's, Triton's, torch
extensions', Python's bytecode) sit under benchmark/.cache, and the
port's kernel library builds into ceph_tpu_torch/build, both inside the
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started, from /proc (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED = time.time() - _process_age()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    marks = {"python": time.time() - STARTED}
    if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import guard
    guard.apply_env(HERE)

    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import cells
    cell = cells.resolve(ROOT, args.workload)
    import torch
    marks["torch"] = time.time() - STARTED
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", torch.cuda.current_device())
    marks["card"] = time.time() - STARTED

    from benchmark.harness import runner
    try:
        result = runner.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                 bool(args.trace), device, STARTED,
                                 log=lambda s: print(s, flush=True),
                                 marks=marks)
    except Exception:  # noqa: BLE001 — the run's one boundary
        traceback.print_exc()
        return 1
    found = guard.forbidden_loaded()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, val in result["checks"].items():
        bound = f"limit {val['limit']}" if "limit" in val \
            else f"at least {val['at_least']}"
        print(f"check {name} {val['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

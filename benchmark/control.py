#!/usr/bin/env python3
"""The readings that set the limits of `correct`, on the card.

    python3 benchmark/control.py --workload k8m3-encode-4m \\
        --seeds 11 12 13 --seconds 2 [--side control|program|both]

For each seed, one short window of the cell at its own load and size:
`program` runs the cell as run.py does; `control` puts the reference,
computed in another field (GF(2^8) mod 0x11b where the configuration
states 0x11d), in the program's place.  Prints one JSON line a seed and
side with the numbers compared and `correct`; the control must come out
not correct.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import guard
    guard.apply_env(HERE)
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--side", choices=("control", "program", "both"),
                    default="both")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("benchmark: the control runs on a CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import runner
    device = torch.device("cuda", torch.cuda.current_device())
    sides = ("program", "control") if args.side == "both" else (args.side,)
    for seed in args.seeds:
        for side in sides:
            t0 = time.time()
            res = runner.run_cell(ROOT, args.workload, seed, args.seconds,
                                  False, device, t0, log=lambda s: None,
                                  control=side == "control")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "correct": res["correct"],
                              "calls": res["attempted"],
                              "seconds": round(time.time() - t0, 3),
                              "checks": res["checks"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""crushtool-role CLI: compile, decompile, and test crush map text
(reference src/tools/crushtool.cc over CrushCompiler/CrushTester).

    python -m ceph_tpu_torch.tools.crushtool --compile map.txt
    python -m ceph_tpu_torch.tools.crushtool --decompile map.txt  # round-trip
    python -m ceph_tpu_torch.tools.crushtool --test map.txt --rule 0 \\
        --num-rep 3 [--inputs 1024]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..crush.compiler import (CrushCompileError, compile_text,
                              decompile, test_rule)


def main(argv=None) -> int:
    # `crushtool ... | head` must not traceback on the closed pipe
    import signal
    try:
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    except (AttributeError, ValueError):
        pass
    ap = argparse.ArgumentParser(prog="crushtool")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--compile", metavar="FILE",
                   help="parse + validate; prints a summary")
    g.add_argument("--decompile", metavar="FILE",
                   help="parse then re-emit canonical text")
    g.add_argument("--test", metavar="FILE",
                   help="run placement checks on a rule")
    ap.add_argument("--rule", type=int, default=0)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--inputs", type=int, default=1024)
    args = ap.parse_args(argv)

    path = args.compile or args.decompile or args.test
    try:
        with open(path) as f:
            compiled = compile_text(f.read())
    except CrushCompileError as e:
        print(f"crushtool: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"crushtool: {e}", file=sys.stderr)
        return 1

    if args.decompile:
        sys.stdout.write(decompile(compiled))
        return 0
    if args.test:
        if args.rule not in compiled.map.rules:
            print(f"crushtool: no rule id {args.rule}",
                  file=sys.stderr)
            return 1
        res = test_rule(compiled.map, args.rule, args.num_rep,
                        args.inputs)
        print(json.dumps({
            "ok": res["ok"],
            "problems": res["problems"][:8],
            "utilization": {f"osd.{d}": c
                            for d, c in sorted(
                                res["utilization"].items())},
        }, indent=2))
        return 0 if res["ok"] else 1
    cm = compiled.map
    print(f"ok: {len(cm.devices)} devices, {len(cm.buckets)} buckets, "
          f"{len(cm.rules)} rules")
    return 0


if __name__ == "__main__":
    sys.exit(main())

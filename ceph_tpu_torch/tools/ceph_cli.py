"""`ceph` CLI: JSON admin-command dispatch to the mon.

Re-expresses the reference's src/ceph.in command surface for the
commands this build's mon implements:

  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT status
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT health     # SLOW_OPS etc.
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd tree
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd pool ls
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd pool create NAME \
      [--type erasure --profile NAME --pg-num N --size N]
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd pool set NAME \
      {pg_num N | pg_autoscale_mode on|warn}  # pg_num up = split, down = merge
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT pg stat      # recovery counts
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT progress     # mgr progress
      # events (recovery/backfill/reshard completion fractions)
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd reweight ID W
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd drain ID  # weight -> 0
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd ok-to-stop ID
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd safe-to-destroy ID
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd rm ID    # guarded remove
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd pool get NAME [VAR]
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd erasure-code-profile \
      set NAME k=4 m=2 plugin=torch
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd erasure-code-profile \
      {get NAME | ls}
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd mclock profile get
  python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT osd mclock profile \
      set PROFILE [CLASS:RES,WGT,LIM;...]   # rides central config to OSDs
  python -m ceph_tpu_torch.tools.ceph_cli daemon /path/to/osd.N.asok \
      {dump_latencies | dump_mclock | perf dump | mesh status |
       repair status | launch profile | compile ledger | ...}
      # local asok, no mon needed (reference `ceph daemon`);
      # `mesh status` = the multichip plane state (docs/MULTICHIP.md);
      # `repair status` = recovery backlog/throttle + per-PG repair
      # ledger (docs/REPAIR.md);
      # `launch profile` = the device-plane flight recorder's launch
      # ledger, `compile ledger` = per-host jit-bucket compile
      # attribution (docs/TRACING.md "Device plane");
      # `pg ledger` = the control-plane flight recorder: per-PG
      # state-machine transitions, stage timings, degraded windows
      # (docs/TRACING.md "Control plane");
      # `messenger status` = the wire-plane flight recorder: reactor
      # loop lag, dispatch-queue depth/wait, wire totals; `conn
      # profile` = per-peer msgs/bytes by type, reconnects, replay
      # (docs/TRACING.md "Wire plane")
  python -m ceph_tpu_torch.tools.ceph_cli daemon /path/to/mon.0.asok \
      osdmap status
      # mon map-distribution ledger: full/incremental/keepalive sends,
      # bytes shipped vs the full-publish equivalent, incremental ring
      # span, batched mutations (docs/ARCHITECTURE.md "Map
      # distribution")
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_addr(s: str) -> tuple[str, int]:
    host, port = s.rsplit(":", 1)
    return host, int(port)


def daemon_command(argv: list[str]) -> int:
    """`ceph daemon PATH CMD [KEY VALUE ...]` — straight to a local
    admin socket, mon not required (reference src/ceph.in daemon
    mode).  The tail-latency commands live here: `dump_latencies`
    (percentile summary of every latency histogram) and `dump_mclock`
    (per-class QoS state)."""
    if len(argv) < 2:
        print("ceph daemon: usage: daemon ASOK_PATH COMMAND "
              "[KEY VALUE ...]", file=sys.stderr)
        return 22
    from ..common.admin_socket import admin_command
    path, prefix = argv[0], argv[1]
    extra = argv[2:]
    # multi-word prefixes ride unquoted (`daemon ASOK mesh status`,
    # `daemon ASOK perf dump`, `daemon ASOK launch queue status`):
    # fold words into the prefix while it is still a known INCOMPLETE
    # command head — so an arg typo elsewhere (`config set debug_osd`
    # missing its value) still fails fast instead of becoming a bogus
    # prefix.  Parity-based folding alone cannot reach the three-word
    # `launch queue status`, hence the head-driven loop.
    heads = ("perf", "config", "log", "mesh", "launch", "launch queue",
             "repair", "osdmap", "compile", "prewarm", "bucket",
             "bucket reshard", "bucket limit", "pg", "messenger",
             "conn")
    while extra and prefix in heads:
        prefix = f"{prefix} {extra[0]}"
        extra = extra[1:]
    if len(extra) % 2:
        print("ceph daemon: trailing KEY without VALUE",
              file=sys.stderr)
        return 22
    cmd = {"prefix": prefix}
    for k, v in zip(extra[::2], extra[1::2]):
        cmd[k] = v
    out = admin_command(path, cmd)
    print(json.dumps(out, indent=2, sort_keys=True))
    return 1 if isinstance(out, dict) and "error" in out else 0


def main(argv=None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    if raw and raw[0] == "daemon":
        return daemon_command(raw[1:])
    ap = argparse.ArgumentParser(prog="ceph")
    ap.add_argument("-m", "--mon", required=True)
    ap.add_argument("--type", default="replicated")
    ap.add_argument("--profile", default="default")
    ap.add_argument("--pg-num", type=int, default=8)
    ap.add_argument("--size", type=int, default=3)
    ap.add_argument("words", nargs="+")
    from .rados_cli import add_auth_args, cli_auth
    add_auth_args(ap)
    args = ap.parse_args(raw)
    words = args.words

    from ..osdc import Objecter

    auth, secure = cli_auth(args)
    obj = Objecter(parse_addr(args.mon), "ceph-cli", auth=auth,
                   secure=secure)
    try:
        obj.start()
        cmd = None
        if words == ["status"]:
            cmd = {"prefix": "status"}
        elif words == ["health"]:
            cmd = {"prefix": "health"}
        elif words == ["osd", "tree"]:
            cmd = {"prefix": "osd tree"}
        elif words == ["osd", "pool", "ls"]:
            cmd = {"prefix": "osd pool ls"}
        elif words[:3] == ["osd", "pool", "create"] and len(words) == 4:
            cmd = {"prefix": "osd pool create", "name": words[3],
                   "type": args.type, "pg_num": args.pg_num,
                   "size": args.size,
                   "erasure_code_profile": args.profile}
        elif words[:3] == ["osd", "pool", "set"] and len(words) == 6:
            cmd = {"prefix": "osd pool set", "pool": words[3],
                   "var": words[4], "val": words[5]}
        elif words[:3] == ["osd", "pool", "get"] and len(words) in (4, 5):
            cmd = {"prefix": "osd pool get", "pool": words[3]}
            if len(words) == 5:
                cmd["var"] = words[4]
        elif words[:3] == ["osd", "erasure-code-profile", "set"] \
                and len(words) >= 4:
            name = words[3]
            prof = dict(w.split("=", 1) for w in words[4:] if "=" in w)
            cmd = {"prefix": "osd erasure-code-profile set", "name": name,
                   "profile": prof}
        elif words[:3] == ["osd", "erasure-code-profile", "get"] \
                and len(words) >= 4:
            cmd = {"prefix": "osd erasure-code-profile get",
                   "name": words[3]}
        elif words[:3] == ["osd", "erasure-code-profile", "ls"]:
            cmd = {"prefix": "osd erasure-code-profile ls"}
        elif words == ["mon", "stat"]:
            cmd = {"prefix": "mon stat"}
        elif words == ["pg", "stat"]:
            cmd = {"prefix": "pg stat"}
        elif words == ["progress"]:
            cmd = {"prefix": "progress"}
        elif words[:4] == ["osd", "mclock", "profile", "get"]:
            cmd = {"prefix": "osd mclock profile get"}
        elif words[:4] == ["osd", "mclock", "profile", "set"] \
                and len(words) in (5, 6):
            cmd = {"prefix": "osd mclock profile set",
                   "profile": words[4]}
            if len(words) == 6:
                cmd["custom"] = words[5]
        elif words[:2] == ["osd", "reweight"] and len(words) == 4:
            cmd = {"prefix": "osd reweight", "id": int(words[2]),
                   "weight": float(words[3])}
        elif words[:2] in (["osd", "out"], ["osd", "in"],
                           ["osd", "down"], ["osd", "drain"],
                           ["osd", "ok-to-stop"],
                           ["osd", "safe-to-destroy"],
                           ["osd", "rm"]) and len(words) == 3:
            cmd = {"prefix": f"osd {words[1]}", "id": int(words[2])}
        elif words[:2] == ["auth", "get-or-create"] and len(words) >= 3:
            cmd = {"prefix": "auth get-or-create", "entity": words[2],
                   "caps": " ".join(words[3:]) or "allow *"}
        elif words[:2] == ["auth", "get"] and len(words) == 3:
            cmd = {"prefix": "auth get", "entity": words[2]}
        elif words == ["auth", "ls"]:
            cmd = {"prefix": "auth ls"}
        elif words[:2] == ["auth", "rm"] and len(words) == 3:
            cmd = {"prefix": "auth rm", "entity": words[2]}
        elif words[:2] == ["config", "set"] and len(words) == 5:
            cmd = {"prefix": "config set", "section": words[2],
                   "name": words[3], "value": words[4]}
        elif words[:2] == ["config", "get"] and len(words) in (3, 4):
            cmd = {"prefix": "config get", "section": words[2]}
            if len(words) == 4:
                cmd["name"] = words[3]
        elif words[:2] == ["config", "rm"] and len(words) == 4:
            cmd = {"prefix": "config rm", "section": words[2],
                   "name": words[3]}
        elif words == ["config", "dump"]:
            cmd = {"prefix": "config dump"}
        elif words[:2] == ["fs", "new"] and len(words) == 5:
            cmd = {"prefix": "fs new", "name": words[2],
                   "metadata_pool": words[3], "data_pool": words[4]}
        elif words[:2] == ["fs", "rm"] and len(words) == 3:
            cmd = {"prefix": "fs rm", "name": words[2]}
        elif words == ["fs", "ls"]:
            cmd = {"prefix": "fs ls"}
        elif words == ["fs", "dump"]:
            cmd = {"prefix": "fs dump"}
        elif words == ["mgr", "dump"]:
            cmd = {"prefix": "mgr dump"}
        elif words == ["mgr", "fail"]:
            cmd = {"prefix": "mgr fail"}
        if cmd is None:
            print(f"ceph: unknown command {' '.join(words)!r}",
                  file=sys.stderr)
            return 22
        result, out = obj.mon_command(cmd)
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0 if result == 0 else 1
    finally:
        obj.shutdown()


if __name__ == "__main__":
    sys.exit(main())

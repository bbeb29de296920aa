"""cephadm-role cluster deployer: spec file -> running daemons.

Re-expresses the reference's deployment story (src/cephadm/cephadm:
declarative service specs, per-daemon unit files, `cephadm ls/rm-
cluster`) at this build's scale — containers are out of scope, so a
"unit" is a supervised OS process (daemon_main) whose command line,
pid, and log land under the cluster directory, restartable
individually:

    ceph-tpu-deploy apply spec.json --dir /var/lib/ceph-tpu
    ceph-tpu-deploy ls     --dir /var/lib/ceph-tpu
    ceph-tpu-deploy stop   --dir /var/lib/ceph-tpu [--name osd.2]
    ceph-tpu-deploy start  --dir /var/lib/ceph-tpu --name osd.2
    ceph-tpu-deploy rm-cluster --dir /var/lib/ceph-tpu

Spec (JSON, the service-spec role):

    {
      "mons": 3,
      "osds": 4,
      "objectstore": "filestore",
      "mds": ["a"],
      "rgw": 1,
      "conf": {"osd_max_backfills": "2"}
    }

Each daemon gets <dir>/<name>/ (data) and <dir>/units/<name>.json
recording argv + addr + pid — the unit-file role: `start` re-execs
exactly what `apply` wrote, surviving deployer restarts.

The mons and OSDs run their EC codecs on `apply --device` (the card,
"cuda", by default; "cpu" runs the kernels' plain versions), recorded
in their units' argv; the `mds` and `rgw` roles run no codec and take
no `--device`.  The unit files, `spec.json` and `monmap.json` have
ceph_tpu's format, so either package's `ls`, `stop`, `start` and
`rm-cluster` read a directory the other's `apply` wrote:

    python -m ceph_tpu_torch.tools.deploy apply spec.json --dir D \
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path


def _unit_dir(root: Path) -> Path:
    d = root / "units"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _write_unit(root: Path, name: str, argv: list[str],
                pid: int, addr: str) -> None:
    (_unit_dir(root) / f"{name}.json").write_text(json.dumps(
        {"name": name, "argv": argv, "pid": pid, "addr": addr,
         "started": time.time()}, indent=2))


def _load_units(root: Path) -> dict[str, dict]:
    out = {}
    for p in sorted(_unit_dir(root).glob("*.json")):
        out[p.stem] = json.loads(p.read_text())
    return out


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _spawn(root: Path, name: str, argv: list[str]) -> str:
    """Start one daemon process, wait for READY (shared handshake
    reader, proc_cluster.wait_ready), record the unit."""
    from .proc_cluster import wait_ready
    log = open(root / f"{name}.log", "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_main",
         *argv],
        stdout=subprocess.PIPE, stderr=log)
    try:
        addr = wait_ready(proc, name)
    except RuntimeError as e:
        proc.kill()
        raise RuntimeError(f"{e} (see {root / (name + '.log')})") from e
    _write_unit(root, name, argv, proc.pid, addr)
    return addr


def cmd_apply(args) -> int:
    root = Path(args.dir)
    root.mkdir(parents=True, exist_ok=True)
    existing = _load_units(root)
    if existing:
        # a second apply would overwrite the unit records and orphan
        # the running daemons beyond stop/rm-cluster's reach
        print(f"cluster dir {root} already has "
              f"{len(existing)} unit(s); run rm-cluster first",
              file=sys.stderr)
        return 1
    spec = json.loads(Path(args.spec).read_text())
    (root / "spec.json").write_text(json.dumps(spec, indent=2))
    n_mons = int(spec.get("mons", 1))
    # fixed mon ports recorded in the cluster dir (the monmap role)
    from .proc_cluster import _free_ports
    ports = _free_ports(n_mons)
    mon_addrs = ",".join(f"127.0.0.1:{p}" for p in ports)
    (root / "monmap.json").write_text(json.dumps(
        {"mons": mon_addrs.split(",")}))
    for rank in range(n_mons):
        _spawn(root, f"mon.{rank}", [
            "mon", "--rank", str(rank), "--addrs", mon_addrs,
            "--data-dir", str(root / f"mon.{rank}"),
            "--device", args.device])
    conf_args = []
    for k, v in (spec.get("conf") or {}).items():
        conf_args += ["--conf", f"{k}={v}"]
    for i in range(int(spec.get("osds", 0))):
        _spawn(root, f"osd.{i}", [
            "osd", "--id", str(i), "--mon", mon_addrs,
            "--objectstore", spec.get("objectstore", "filestore"),
            "--data-dir", str(root / f"osd.{i}"), *conf_args,
            "--device", args.device])
    for name in spec.get("mds", []):
        _spawn(root, f"mds.{name}", [
            "mds", "--name", name, "--mon", mon_addrs])
    for i in range(int(spec.get("rgw", 0))):
        addr = _spawn(root, f"rgw.{i}", ["rgw", "--mon", mon_addrs])
        print(f"rgw.{i} serving at http://{addr}")
    print(f"cluster up: mons at {mon_addrs}")
    return 0


def cmd_ls(args) -> int:
    units = _load_units(Path(args.dir))
    for name, u in units.items():
        state = "running" if _alive(u["pid"]) else "dead"
        print(json.dumps({"name": name, "state": state,
                          "pid": u["pid"], "addr": u["addr"]}))
    return 0


def _stop_one(root: Path, name: str, u: dict) -> None:
    if _alive(u["pid"]):
        os.kill(u["pid"], signal.SIGTERM)
        for _ in range(50):
            if not _alive(u["pid"]):
                break
            time.sleep(0.1)
        if _alive(u["pid"]):
            os.kill(u["pid"], signal.SIGKILL)


def cmd_stop(args) -> int:
    root = Path(args.dir)
    units = _load_units(root)
    targets = [args.name] if args.name else list(units)
    for name in targets:
        if name not in units:
            print(f"no such daemon {name}", file=sys.stderr)
            return 1
        _stop_one(root, name, units[name])
        print(f"stopped {name}")
    return 0


def cmd_start(args) -> int:
    root = Path(args.dir)
    units = _load_units(root)
    u = units.get(args.name)
    if u is None:
        print(f"no such daemon {args.name}", file=sys.stderr)
        return 1
    if _alive(u["pid"]):
        print(f"{args.name} already running (pid {u['pid']})")
        return 0
    addr = _spawn(root, args.name, u["argv"])
    print(f"started {args.name} at {addr}")
    return 0


def cmd_rm_cluster(args) -> int:
    root = Path(args.dir)
    units = _load_units(root)
    for name, u in units.items():
        _stop_one(root, name, u)
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    print(f"removed cluster at {root}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph-tpu-deploy")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("apply")
    p.add_argument("spec")
    p.add_argument("--dir", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the mons' and OSDs' EC codecs run "
                        "(default: the card)")
    p.set_defaults(fn=cmd_apply)
    p = sub.add_parser("ls")
    p.add_argument("--dir", required=True)
    p.set_defaults(fn=cmd_ls)
    p = sub.add_parser("stop")
    p.add_argument("--dir", required=True)
    p.add_argument("--name")
    p.set_defaults(fn=cmd_stop)
    p = sub.add_parser("start")
    p.add_argument("--dir", required=True)
    p.add_argument("--name", required=True)
    p.set_defaults(fn=cmd_start)
    p = sub.add_parser("rm-cluster")
    p.add_argument("--dir", required=True)
    p.set_defaults(fn=cmd_rm_cluster)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Single-daemon process entrypoint (reference src/ceph_mon.cc /
src/ceph_osd.cc main(): one daemon per OS process).

Spawned by ProcCluster (proc_cluster.py) — the multi-process topology
in which kill -9 is a real SIGKILL, concurrency is real parallelism
(no shared GIL), and serialization bugs can't hide behind shared
memory.  Also usable standalone:

    python -m ceph_tpu_torch.tools.daemon_main mon --rank 0 \\
        --addrs 127.0.0.1:7001,127.0.0.1:7002,127.0.0.1:7003
    python -m ceph_tpu_torch.tools.daemon_main osd --id 0 \\
        --mon 127.0.0.1:7001 --objectstore bluestore --data-dir /tmp/o0

Each daemon runs its EC codecs on `--device` (the card, "cuda", by
default; "cpu" runs the kernels' plain versions).  The daemon selects
its card before it builds a codec; a CUDA request without a GPU exits
non-zero at boot.  `--asok PATH` serves the daemon's admin socket.  The
`mds` and `rgw` roles need services that are not ported (fs, rgw): they
exit with an error naming them.

Prints one "READY <addr>" line on stdout once serving, then runs until
SIGTERM/SIGKILL.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

NOT_PORTED_ROLES = {"mds": "fs (the MDS and CephFS client)",
                    "rgw": "rgw (the S3 gateway)"}


def _parse_addr(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return (host, int(port))


def _select_device(device: str) -> str:
    """Resolve the daemon's device and make it the process's current
    card, before anything builds a codec or a pinned buffer.  Raises
    where CUDA is asked for and no GPU exists."""
    import torch

    from .. import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return str(dev)


def run_mon(args) -> int:
    from ..mon import Monitor
    device = _select_device(args.device)
    addrs = [_parse_addr(a) for a in args.addrs.split(",")]
    mon = Monitor(addr=addrs[args.rank],
                  failure_quorum=args.failure_quorum,
                  data_dir=args.data_dir, asok_path=args.asok,
                  device=device)
    if len(addrs) > 1:
        mon.join(addrs, args.rank)
    print(f"READY {mon.addr[0]}:{mon.addr[1]}", flush=True)
    _serve_forever(mon.shutdown)
    return 0


def _configure_mesh(conf: dict, device: str) -> None:
    """A mesh-enabled daemon (osd_ec_use_mesh) configures the host's
    MeshService from its conf before the daemon's first PG asks for
    it: over the CUDA devices on the card, over `n` repeats of the CPU
    (its S x D from mesh_devices, 8 when the spec gives no count) on
    the CPU.  A bad spec is left for the daemon, which logs it and runs
    the single-card plane."""
    val = str(conf.get("osd_ec_use_mesh", "")).lower()
    if val not in ("true", "1", "yes", "on"):
        return
    from ..parallel.service import MeshError, MeshService, parse_mesh_shape
    spec = str(conf.get("mesh_devices", ""))
    visible = None
    if device == "cpu":
        try:
            n_shard, n_data = parse_mesh_shape(spec, 8)
        except MeshError:
            return
        visible = ["cpu"] * (n_shard * n_data)
    try:
        MeshService.configure(spec, visible=visible)
    except MeshError:
        return


def run_osd(args) -> int:
    conf = {}
    for kv in args.conf or []:
        k, _, v = kv.partition("=")
        conf[k] = v
    device = _select_device(args.device)
    _configure_mesh(conf, device)
    from ..osd.daemon import OSDDaemon
    from ..store import create_store
    store = create_store(args.objectstore, args.data_dir)
    mons = [_parse_addr(a) for a in args.mon.split(",")]
    # conf rides the constructor: startup options (osd_op_queue) pick
    # construction-time shape and must precede anything reading them
    osd = OSDDaemon(args.id, mons, store=store,
                    heartbeat_interval=args.heartbeat,
                    asok_path=args.asok, conf=conf, device=device)
    osd.boot()
    print(f"READY {osd.addr[0]}:{osd.addr[1]}", flush=True)
    _serve_forever(osd.shutdown)
    return 0


def run_not_ported(args) -> int:
    print(f"daemon_main: the {args.role} role needs "
          f"{NOT_PORTED_ROLES[args.role]}, which is not ported to "
          f"ceph_tpu_torch", file=sys.stderr, flush=True)
    return 2


def _serve_forever(on_term) -> None:
    stop = []

    def _term(_sig, _frm):
        stop.append(1)
    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop:
        time.sleep(0.2)
    try:
        on_term()
    except Exception:  # noqa: BLE001 - dying anyway
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="daemon_main")
    sub = ap.add_subparsers(dest="role", required=True)

    mp = sub.add_parser("mon")
    mp.add_argument("--rank", type=int, default=0)
    mp.add_argument("--addrs", required=True,
                    help="comma list of host:port for ALL mon ranks")
    mp.add_argument("--failure-quorum", type=int, default=2)
    mp.add_argument("--data-dir", default=None)

    op = sub.add_parser("osd")
    op.add_argument("--id", type=int, required=True)
    op.add_argument("--mon", required=True,
                    help="comma list of mon host:port")
    op.add_argument("--objectstore", default="memstore")
    op.add_argument("--data-dir", default=None)
    op.add_argument("--heartbeat", type=float, default=1.0)
    op.add_argument("--conf", action="append", default=[],
                    help="k=v config overrides (repeatable)")

    for p in (mp, op):
        p.add_argument("--device", choices=("cuda", "cpu"),
                       default="cuda",
                       help="where the EC codecs run (default: the card)")
        p.add_argument("--asok", default=None,
                       help="admin socket path")

    dp = sub.add_parser("mds")
    dp.add_argument("--mon", required=True)
    dp.add_argument("--name", default="a")

    gp = sub.add_parser("rgw")
    gp.add_argument("--mon", required=True)
    gp.add_argument("--port", type=int, default=0)

    args = ap.parse_args(argv)
    return {"mon": run_mon, "osd": run_osd, "mds": run_not_ported,
            "rgw": run_not_ported}[args.role](args)


if __name__ == "__main__":
    sys.exit(main())

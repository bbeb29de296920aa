"""End-to-end cluster throughput bench (reference `rados bench`,
src/tools/rados/rados.cc + qa/tasks/radosbench.py).

Measures the FULL system tier no codec-level number covers: client ->
objecter -> messenger -> OSD dispatch -> EC/replication pipeline ->
store commit -> ack, with concurrent writers, on an in-process vstart
cluster.  Rows (one JSON line each):

  python -m ceph_tpu_torch.tools.cluster_bench            # default matrix
  python -m ceph_tpu_torch.tools.cluster_bench --seconds 5 --threads 8
  python -m ceph_tpu_torch.tools.cluster_bench --quick --device cpu

Matrix: replicated x3, EC k=2 m=1, EC k=8 m=3 (the reference's
canonical profile) — each on MemStore; EC additionally with the
dynamic batch window on vs off (tpu_batch_window_ms) to quantify the
cross-transaction batching the card's pipeline exists for.  `--mesh`
puts every EC PG whose matrix the MeshService accepts (jerasure
reed_sol_van's too) on the device mesh, and adds a k=8 m=3 row on the
`torch` plugin, the one row that publishes its mesh.

The cluster's codecs run on `--device` (the card, "cuda", by default;
"cpu" runs the kernels' plain versions); asking for the card without a
GPU raises.  Each EC row's `launch_ledger` carries the host flight
recorder's summary and `kernel_launches`, the row's launches by kernel
wrapper (this process's in the thread topology, every OSD's `launch
profile` in the process topology).

`--scale [N]` (default 64) is the CONTROL-PLANE row instead: stand up
the largest thread-topology cluster the box allows, churn map epochs
via split + merge + drain + kill/revive UNDER write load, and gate
  - map bytes shipped per epoch vs the full-publish equivalent
    (>= SCALE_MAP_RATIO_MIN, default 10x — the incremental-publish
    claim, docs/ARCHITECTURE.md "Map distribution"),
  - heartbeat keepalives counted (a current daemon's tick is ~free),
  - incremental-applied maps bit-equal to the mon's on every daemon,
  - time-to-active-clean after the churn with ZERO acked-write loss.
One BENCH-comparable JSON line; rc != 0 on any gate failure.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np


def bench_pool(cluster, client, pool: str, seconds: float,
               threads: int, size: int) -> dict:
    from .latency import LatencyRecorder
    io = client.open_ioctx(pool)
    payload = np.random.default_rng(7).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    stop = time.time() + seconds
    counts = [0] * threads
    # per-op latency samples + errors bucketed by exception type (a
    # bare error count hid WHAT failed; reference `rados bench` keeps
    # per-op latencies the same way)
    wlat = LatencyRecorder("write")
    rlat = LatencyRecorder("read")

    def writer(t: int) -> None:
        i = 0
        myio = client.open_ioctx(pool)
        while time.time() < stop:
            t0 = time.perf_counter()
            try:
                myio.write_full(f"b_{t}_{i}", payload)
                wlat.record(time.perf_counter() - t0)
                counts[t] += 1
            except Exception as e:  # noqa: BLE001
                wlat.error(e)
            i += 1

    ts = [threading.Thread(target=writer, args=(t,)) for t in
          range(threads)]
    t0 = time.time()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    elapsed = time.time() - t0
    wrote = sum(counts)
    # Settle before the read phase: trailing write-pipeline work
    # (acks, roll-forward, retention trims) otherwise competes with
    # the reads and understates the read path ~2x.  The reference's
    # `rados bench seq` is likewise a separate phase run against a
    # settled pool, not the tail of the write storm.
    time.sleep(2.0)
    # read-back verification pass (sequential, first writer's objects)
    r0 = time.time()
    rn = 0
    for i in range(min(counts[0], 64)):
        rt0 = time.perf_counter()
        try:
            got = io.read(f"b_0_{i}", size)
        except Exception as e:  # noqa: BLE001
            rlat.error(e)
            continue
        rlat.record(time.perf_counter() - rt0)
        assert got == payload, "read-back mismatch"
        rn += 1
    relapsed = time.time() - r0
    wsum, rsum = wlat.summary(), rlat.summary()
    by_type = dict(wsum["errors_by_type"])
    for k, v in rsum["errors_by_type"].items():
        by_type[k] = by_type.get(k, 0) + v
    return {
        "write_mb_s": round(wrote * size / elapsed / 1e6, 2),
        "write_iops": round(wrote / elapsed, 1),
        "ops": wrote,
        "errors": wsum["errors"] + rsum["errors"],
        "errors_by_type": by_type,
        "write_lat": {k: v for k, v in wsum.items()
                      if k not in ("errors", "errors_by_type")},
        "read_lat": {k: v for k, v in rsum.items()
                     if k not in ("errors", "errors_by_type")},
        "read_mb_s": round(rn * size / relapsed / 1e6, 2)
        if relapsed > 0 and rn else None,
    }


def _setup_profiles(client, mesh: bool = False) -> None:
    client.set_ec_profile("cb21", {
        "plugin": "jerasure", "k": "2", "m": "1",
        "stripe_unit": "4096"})
    client.set_ec_profile("cb83", {
        "plugin": "jerasure", "k": "8", "m": "3",
        "stripe_unit": "4096"})
    if mesh:
        # the mesh plane requires a matrix-compatible plugin (the torch
        # cauchy codec shares the MeshService generator matrix;
        # jerasure's cauchy_good would fall back with a config error)
        client.set_ec_profile("cb83x", {
            "plugin": "torch", "k": "8", "m": "3",
            "technique": "cauchy", "stripe_unit": "4096"})


def _make_pool(client, name: str, profile: str | None) -> str:
    pool = f"pool_{name}"
    if profile:
        client.create_pool(pool, "erasure",
                           erasure_code_profile=profile, pg_num=16)
    else:
        client.create_pool(pool, "replicated", size=3, pg_num=16)
    return pool


def _matrix(args) -> list[tuple[str, str | None, float]]:
    """ONE matrix for both topologies (the A/B claim depends on it)."""
    rows = [("replicated", None, 0.0)]
    if not args.quick:
        rows.append(("ec_k2m1", "cb21", 0.0))
    rows += [("ec_k8m3", "cb83", 0.0),
             ("ec_k8m3_batched", "cb83", args.window_ms)]
    if args.mesh is not None:
        # mesh-plane A/B row: torch-plugin profile so the EC backends
        # actually acquire the MeshService codec (docs/MULTICHIP.md)
        rows.append(("ec_k8m3_mesh", "cb83x", 0.0))
    return rows


def _osd_asoks(c) -> list[str]:
    """The admin sockets of a process cluster's running OSDs."""
    return [c.asok_path(f"osd.{i}") for i, p in enumerate(c.osd_procs)
            if p is not None]


def _row_mesh(c, args, profile) -> str | None:
    """The `mesh` field for a published row: the shape string only
    when a mesh plane ACTUALLY served the row, else null.  The thread
    topology reads the live backends, the process topology each OSD's
    `mesh status` (an ECBackend that fell back to the single-card
    plane must not be published as a mesh run)."""
    if args.mesh is None or profile != "cb83x":
        return None
    if hasattr(c, "osds"):          # thread topology: inspect planes
        states = [st.backend.mesh_status() for osd in c.osds
                  for st in getattr(osd, "pgs", {}).values()
                  if st.kind == "ec"]
    else:
        from ..common.admin_socket import admin_command
        states = [ms for path in _osd_asoks(c)
                  for ms in admin_command(path, {"prefix": "mesh status"})
                  .get("pgs", {}).values()]
    for ms in states:
        if ms["active"]:
            m = ms["mesh"]
            return f"{m['shard']}x{m['data']}"
    return None


def _kernel_launches(c) -> dict[str, int]:
    """Kernel launches so far, by kernel wrapper: this process's counts
    (the thread topology's daemons share it), or the sum of every
    running OSD's `launch profile` (the process topology)."""
    if hasattr(c, "osds"):
        from ..ops import bitsliced
        return bitsliced.launch_counts()
    from ..common.admin_socket import admin_command
    total: dict[str, int] = {}
    for path in _osd_asoks(c):
        got = admin_command(path, {"prefix": "launch profile"})
        for k, n in got["kernel_launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def _bench_row(c, client, args, name, profile, window,
               extra: dict) -> dict:
    pool = _make_pool(client, name, profile)
    launched = _kernel_launches(c)
    res = bench_pool(c, client, pool, args.seconds, args.threads,
                     args.size)
    # `mesh` distinguishes mesh-plane rows from single-chip rows in
    # the published JSON (shape string, or null) — resolved from the
    # cluster AFTER the row ran, not from the CLI flag
    row = {"config": name, "objectstore": args.objectstore,
           "threads": args.threads, "obj_size": args.size,
           "batch_window_ms": window,
           "mesh": _row_mesh(c, args, profile), **res, **extra}
    # device-plane provenance: EC rows embed the host
    # flight recorder's summary so a rate move is attributable to
    # compiles / launch occupancy without re-running with an asok
    from ..ops.profiler import device_profiler
    row["launch_ledger"] = device_profiler().bench_summary()
    row["launch_ledger"]["kernel_launches"] = {
        k: n - launched.get(k, 0) for k, n in _kernel_launches(c).items()}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cluster_bench")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--size", type=int, default=1 << 20)
    ap.add_argument("--osds", type=int, default=12)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the cluster's EC codecs run (default: "
                         "the card)")
    ap.add_argument("--objectstore", default="memstore")
    ap.add_argument("--window-ms", type=float, default=4.0,
                    help="batch window for the windowed EC rows")
    ap.add_argument("--quick", action="store_true",
                    help="small matrix (replicated + one EC profile)")
    ap.add_argument("--mesh", nargs="?", const="", default=None,
                    metavar="SxD|N",
                    help="add a mesh-plane EC row: enable the "
                         "multichip MeshService on the cluster "
                         "('SxD' shape, device count, or bare flag = "
                         "all visible devices)")
    ap.add_argument("--processes", action="store_true",
                    help="multi-process topology (ProcCluster): each "
                         "daemon its own interpreter — cluster numbers "
                         "measure the system, not one GIL")
    ap.add_argument("--scale", nargs="?", type=int, const=64,
                    default=None, metavar="N",
                    help="control-plane scale row instead of the I/O "
                         "matrix: N-OSD cluster (default 64), epoch "
                         "churn under load, incremental-map + "
                         "active-clean + zero-loss gates, rc!=0 on "
                         "failure")
    ap.add_argument("--heartbeat", type=float, default=2.0,
                    help="heartbeat interval for the --scale cluster "
                         "(failure detection + mon keepalive cadence)")
    ap.add_argument("--hb-peers", type=int, default=6,
                    help="osd_heartbeat_min_peers for the --scale "
                         "cluster (ring-subset ping fan-out)")
    ap.add_argument("--hb-grace", type=float, default=10.0,
                    help="osd_heartbeat_grace for the --scale cluster "
                         "(missed-ping multiplier; generous so python "
                         "thread scheduling jitter on a small box "
                         "doesn't flap daemons down)")
    ap.add_argument("--prewarm", action="store_true",
                    help="--scale only: boot with the jit-bucket "
                         "prewarm + the kernel library cache "
                         "(CEPH_TPU_TORCH_COMPILE_CACHE for a "
                         "hermetic dir), drive an EC pool through the churn "
                         "with compile-stall injection armed, and "
                         "gate ec_compile_stalls == 0 / no "
                         "COMPILE_STORM")
    args = ap.parse_args(argv)
    from .. import resolve_device
    resolve_device(args.device)     # no GPU for "cuda": raise here

    if args.scale is not None:
        return _main_scale(args)

    if args.processes:
        return _main_processes(args)

    if args.mesh is not None:
        # the thread topology's daemons share this process's
        # MeshService: configure it as a mesh daemon does (over the
        # CUDA devices, or repeats of the CPU); the process topology's
        # daemons each configure their own
        from .daemon_main import _configure_mesh
        _configure_mesh({"osd_ec_use_mesh": True,
                         "mesh_devices": args.mesh}, args.device)

    from ..tools.vstart import Cluster

    import tempfile
    data_dir = tempfile.mkdtemp(prefix="cbench_") \
        if args.objectstore != "memstore" else None
    with Cluster(n_osds=args.osds, objectstore=args.objectstore,
                 data_dir=data_dir, mesh_devices=args.mesh,
                 device=args.device) as c:
        client = c.client()
        _setup_profiles(client, mesh=args.mesh is not None)
        for name, profile, window in _matrix(args):
            for osd in c.osds:
                osd.cct.conf.set("tpu_batch_window_ms", window)
            counters = {
                "codec_launches": -sum(
                    getattr(st.backend, "batched_launches", 0)
                    for osd in c.osds
                    for st in getattr(osd, "pgs", {}).values()),
                "codec_extents": -sum(
                    getattr(st.backend, "batched_extents", 0)
                    for osd in c.osds
                    for st in getattr(osd, "pgs", {}).values())}
            _bench_row(c, client, args, name, profile, window, {})
            # report per-row deltas of the cumulative in-process
            # counters (unavailable cross-process)
            counters["codec_launches"] += sum(
                getattr(st.backend, "batched_launches", 0)
                for osd in c.osds
                for st in getattr(osd, "pgs", {}).values())
            counters["codec_extents"] += sum(
                getattr(st.backend, "batched_extents", 0)
                for osd in c.osds
                for st in getattr(osd, "pgs", {}).values())
            print(json.dumps({"config": name, **counters}), flush=True)
    return 0


BLAME_STAGES = ("peering_s", "scan_s", "decode_s", "push_s",
                "throttle_s")
BLAME_COUNTERS = ("remote_lists", "objects_scanned",
                  "objects_recovered", "transitions")


def _ledger_snapshot(cluster) -> dict[int, dict]:
    """Per-OSD cumulative pg_ledger blame block (osd/pg_ledger)."""
    snaps: dict[int, dict] = {}
    for osd in cluster.osds:
        if osd is None:
            continue
        try:
            snaps[osd.osd_id] = dict(osd.pg_ledger.blame_block())
        except Exception:  # noqa: BLE001 - daemon mid-shutdown
            pass
    return snaps


def _recovery_blame(before: dict[int, dict], after: dict[int, dict],
                    ttac: float | None, window_s: float) -> dict:
    """time_to_active_clean decomposition from the per-OSD control-
    plane ledgers (the recovery-blame gate).  Per stage the value is the
    MAX across OSDs of the window delta — concurrent recovery overlaps
    across daemons, so the max approximates the critical path where a
    sum would count the same wall-second n_osds times.  When the stage
    total still exceeds ttac (stages overlap within one daemon too:
    throttle inside push loops, scans while peers push) the stages are
    folded proportionally onto ttac (`overlap_folded: true`) so the
    published decomposition reads as shares of the clean wait; the raw
    per-stage maxima ride along unfolded."""
    deltas: dict[int, dict] = {}
    for oid, a in after.items():
        b = before.get(oid, {})
        if a.get("transitions", 0) < b.get("transitions", 0):
            b = {}   # daemon restarted mid-window: fresh ledger
        deltas[oid] = {k: a.get(k, 0) - b.get(k, 0)
                       for k in set(a) | set(b)}
    raw = {k: round(max((d.get(k, 0.0) for d in deltas.values()),
                        default=0.0), 4)
           for k in BLAME_STAGES}
    counters = {k: int(sum(d.get(k, 0) for d in deltas.values()))
                for k in BLAME_COUNTERS}
    block: dict = {"stages_raw_s": raw, **counters,
                   "window_s": round(window_s, 2),
                   "osds_reporting": len(deltas)}
    raw_sum = sum(raw.values())
    if ttac is not None and ttac > 0:
        folded = raw_sum > ttac
        scale = (ttac / raw_sum) if folded and raw_sum > 0 else 1.0
        stages = {k: round(v * scale, 4) for k, v in raw.items()}
        block.update(stages)
        block["other_s"] = round(
            max(0.0, ttac - sum(stages.values())), 4)
        block["overlap_folded"] = folded
        block["time_to_active_clean_s"] = ttac
    return block


def _main_scale(args) -> int:
    """The control-plane scale row: where does the control plane
    actually stop scaling?  Epoch churn (split, merge, drain walk,
    kill/revive) on the biggest thread-topology cluster the box
    allows, write load running THROUGH the churn, and the map
    distribution ledger gated against the full-publish baseline."""
    import os
    import queue as _q

    from ..osdc.objecter import TimedOut
    from ..rados.client import RadosError
    from .vstart import Cluster

    n = args.scale
    min_ratio = float(os.environ.get("SCALE_MAP_RATIO_MIN", "10"))
    clean_timeout = float(os.environ.get("SCALE_CLEAN_TIMEOUT_S",
                                         "180"))
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, args.size, dtype=np.uint8).tobytes()
    row: dict = {"metric": "cluster_scale", "osds": n,
                 "obj_size": args.size}
    fail: list[str] = []
    conf = {"osd_heartbeat_min_peers": args.hb_peers,
            "osd_heartbeat_grace": args.hb_grace}
    prewarm_ec = bool(getattr(args, "prewarm", False)) and n >= 12
    if prewarm_ec:
        # compile-stall churn gate: boot prewarmed (the library cache
        # dir from CEPH_TPU_TORCH_COMPILE_CACHE when hermetic CI
        # points one),
        # and ARM the compile-stall injection — any EC launch on a
        # bucket the prewarm failed to cover sleeps 0.5 s in its
        # submit and fails the zero-stall gate below.  Deterministic:
        # with full coverage the injection can never fire.
        conf.update({"osd_ec_prewarm": True,
                     "osd_ec_prewarm_budget_s": 60.0,
                     "osd_ec_inject_compile_stall": 0.5})
    t0 = time.time()
    with Cluster(n_osds=n, heartbeat_interval=args.heartbeat,
                 boot_parallel=True, conf=conf, device=args.device) as c:
        row["boot_s"] = round(time.time() - t0, 2)
        client = None
        for _ in range(5):      # map RT right after a big boot can
            try:                # exceed the client's 10 s start budget
                client = c.client()
                break
            except TimedOut:
                time.sleep(1.0)
        if client is None:
            client = c.client()

        def mcmd(cmd: dict, budget: float = 180.0) -> dict:
            """Mon command with a generous single-attempt window: with
            N daemons + recovery threads sharing this interpreter, an
            ack can starve well past the client's default 3 s attempt
            (and a blind resend of a landed create answers EEXIST);
            EBUSY/EAGAIN (interleave guard, stats refresh) retry."""
            deadline = time.time() + budget
            while True:
                try:
                    r, out = client.objecter.mon_command(
                        cmd, timeout=min(60.0, budget))
                except TimedOut:
                    r, out = -1, {"error": "mon command timeout"}
                if r == 0 or -r == 17:        # ok / EEXIST on resend
                    return out
                if time.time() > deadline:
                    raise RuntimeError(f"{cmd.get('prefix')}: {out}")
                time.sleep(0.5)

        mcmd({"prefix": "osd pool create", "name": "scale",
              "type": "replicated", "size": 3, "pg_num": 32})
        io = client.open_ioctx("scale")
        acked: dict[str, bool] = {}
        acked_q: _q.Queue = _q.Queue()
        stop_writing = threading.Event()
        ec_io = None
        ec_payload = b""
        ec_acked_q: _q.Queue = _q.Queue()
        if prewarm_ec:
            # EC churn lane: k=8,m=3 writes at the default
            # profile's prewarmed geometry (32 KiB objects -> 4 KiB
            # chunk columns) ride THROUGH the kill/revive below, so
            # the zero-stall gate covers encode, degraded decode, and
            # post-revive recovery launches
            mcmd({"prefix": "osd erasure-code-profile set",
                  "name": "scale_ec",
                  "profile": {"plugin": "torch", "technique": "cauchy",
                              "k": "8", "m": "3",
                              "stripe_unit": "1024"}})
            mcmd({"prefix": "osd pool create", "name": "scaleec",
                  "type": "erasure",
                  "erasure_code_profile": "scale_ec", "pg_num": 4})
            ec_io = client.open_ioctx("scaleec")
            ec_payload = rng.integers(0, 256, 32768,
                                      dtype=np.uint8).tobytes()

        def writer(t: int) -> None:
            i = 0
            while not stop_writing.is_set():
                name = f"s_{t}_{i}"
                try:
                    # short per-op budget: a write racing a killed
                    # primary must fail fast and move on, not pin the
                    # churn phase on a 30 s default timeout
                    reply = client.objecter.op_submit(
                        io.pool_id, name,
                        [["writefull", len(payload)]], payload,
                        timeout=5.0, attempts=2)
                    if reply.result == 0:
                        acked_q.put(name)
                except Exception:  # noqa: BLE001 - churn makes every
                    pass           # failure shape expected here
                i += 1

        # the EC lane pauses across the remap windows (ec_gate: drain
        # walk through kill/revive): a write in flight when its shard
        # holders re-peer can wedge the EC pipeline or leave a partial
        # object past the clean-wait (sub-write acks are not resent on
        # re-peer — a known reduction, docs/PIPELINE.md) and that
        # liveness axis is not what this gate measures.  Writes BEFORE
        # the remaps cover the cold-boot buckets, writes AFTER the
        # revives are the acceptance point (warm first launches on a
        # revived daemon); the replicated lane keeps load through the
        # windows themselves.
        ec_gate = threading.Event()
        ec_gate.set()

        def ec_writer(t: int) -> None:
            i = 0
            while not stop_writing.is_set():
                if not ec_gate.is_set():
                    time.sleep(0.1)
                    continue
                name = f"ec_{t}_{i}"
                try:
                    reply = client.objecter.op_submit(
                        ec_io.pool_id, name,
                        [["writefull", len(ec_payload)]], ec_payload,
                        timeout=5.0, attempts=2)
                    if reply.result == 0:
                        ec_acked_q.put(name)
                except Exception:  # noqa: BLE001 - churn failures
                    pass           # expected, like the replicated lane
                i += 1

        # lighter write load at high N: the point is load DURING
        # churn, not peak IOPS — at 64 in-process daemons the GIL is
        # the scarce resource
        n_writers = 2 if n >= 32 else min(args.threads, 4)
        writers = [threading.Thread(target=writer, args=(t,),
                                    daemon=True)
                   for t in range(n_writers)]
        if ec_io is not None:
            writers += [threading.Thread(target=ec_writer, args=(t,),
                                         daemon=True)
                        for t in range(2)]
        for t in writers:
            t.start()
        time.sleep(max(1.0, args.seconds / 2))

        # split/merge churn rides its own pool: the measured axis is
        # CONTROL-PLANE fan-out (epochs, sweeps, re-peering on every
        # daemon), not data migration — resizing the loaded pool at
        # 64 OSDs additionally triggers O(PGs x OSDs) recovery wide
        # scans that swamp a small box for minutes (tier-1's
        # pg_split/pg_merge thrash suites own that axis); drain +
        # kill/revive below still remap the LOADED pool
        mcmd({"prefix": "osd pool create", "name": "churn",
              "type": "replicated", "size": 3, "pg_num": 8})

        def pool_set(val: int, budget: float = 180.0) -> None:
            mcmd({"prefix": "osd pool set", "pool": "churn",
                  "var": "pg_num", "val": val}, budget)

        # recovery-blame EC lane: a small k=2,m=1 pool
        # written BEFORE the churn so the kill/revive below has EC
        # shards to reconstruct — the decode/push stages of the
        # recovery_blame block need a PG that actually decodes.  The
        # prewarm row already runs a live EC lane; reuse it there.
        blame_pool_id = None
        if not prewarm_ec:
            mcmd({"prefix": "osd erasure-code-profile set",
                  "name": "blame_ec",
                  "profile": {"plugin": "torch", "technique": "cauchy",
                              "k": "2", "m": "1",
                              "stripe_unit": "1024"}})
            mcmd({"prefix": "osd pool create", "name": "blameec",
                  "type": "erasure",
                  "erasure_code_profile": "blame_ec", "pg_num": 4})
            bio = client.open_ioctx("blameec")
            blame_payload = rng.integers(
                0, 256, 16384, dtype=np.uint8).tobytes()
            for i in range(8):
                bio.write_full(f"blame_{i}", blame_payload)
            blame_pool_id = bio.pool_id

        churn_t0 = time.time()
        epoch0 = c.mon.osdmap.epoch
        ledger_t0 = _ledger_snapshot(c)
        pool_set(16)                       # split under load
        time.sleep(1.0)
        pool_set(8)                        # merge back (interleave-
        # guarded: retries until split pushes settle)
        # drain, reweight, and kill/revive below all remap the EC
        # pool's acting sets — close the gate across ALL of them, not
        # just the kills: a k=8,m=3 write in flight across ANY remap
        # can strand sub-writes (acks are not resent on re-peer) into
        # a partial object recovery can neither rebuild (> m shards
        # short) nor latch unfound, wedging active+clean.  The
        # split/merge above only resizes the "churn" pool, so the EC
        # lane keeps writing through it.
        if ec_io is not None:
            ec_gate.clear()
            time.sleep(2.0)     # let in-flight EC ops resolve first
        # drain walk: one committed epoch per weight step
        mcmd({"prefix": "osd drain", "id": n - 1, "step": 0.5})
        deadline = time.time() + 60
        while c.mon.osdmap.osds[n - 1].weight > 0 and \
                time.time() < deadline:
            time.sleep(0.2)
        mcmd({"prefix": "osd reweight", "id": n - 1, "weight": 1.0})
        # kill/revive: heartbeat failure reports mark them down (a
        # burst the mon coalesces), revival re-boots them
        victims = [n // 2, n // 2 + 1]
        # blame lane: make sure at least one victim holds blameec
        # shards, so its fresh-store revive below forces a real
        # reconstruct (decode + push) instead of a no-op re-peer
        wipe_victim = None
        if blame_pool_id is not None:
            from ..osd.types import pg_t
            holders: set[int] = set()
            for seed in range(4):
                try:
                    _, acting, _, _ = c.mon.osdmap.pg_to_up_acting_osds(
                        pg_t(blame_pool_id, seed))
                    holders.update(o for o in acting if o >= 0)
                except Exception:  # noqa: BLE001 - mapping gap
                    pass
            hit = [v for v in victims if v in holders]
            if hit:
                wipe_victim = hit[0]
            else:
                extra = [o for o in sorted(holders)
                         if o != n - 1 and o not in victims]
                if extra:
                    wipe_victim = extra[0]
                    victims.append(wipe_victim)
        for v in victims:
            c.kill_osd(v)
        # detection takes heartbeat * grace on the watching peers
        deadline = time.time() + \
            max(30, 3 * args.heartbeat * args.hb_grace)
        while any(c.mon.osdmap.is_up(v) for v in victims) and \
                time.time() < deadline:
            time.sleep(0.2)
        down_ok = not any(c.mon.osdmap.is_up(v) for v in victims)
        if not down_ok:
            fail.append("failure detection never marked victims down")
        for v in victims:
            if v == wipe_victim and c.objectstore == "memstore":
                # revive on an EMPTY store (a reimaged disk): MemStore
                # data normally survives in-process, which would let
                # re-peering skip reconstruction entirely — the blame
                # lane needs the decode path to actually run
                from ..store import create_store
                c.osds[v].store = create_store(c.objectstore, None)
            c.revive_osd(v)
        if ec_io is not None:
            # resume once the map shows the revived daemons up: the
            # post-revive EC writes are the warm-first-launch check
            deadline = time.time() + 30
            while not all(c.mon.osdmap.is_up(v) for v in victims) \
                    and time.time() < deadline:
                time.sleep(0.2)
            ec_gate.set()
        time.sleep(max(1.0, args.seconds / 2))
        stop_writing.set()
        for t in writers:
            t.join(timeout=30)
        while not acked_q.empty():
            acked[acked_q.get()] = True
        row["churn_s"] = round(time.time() - churn_t0, 2)
        row["epochs_churned"] = c.mon.osdmap.epoch - epoch0

        clean_t0 = time.time()
        try:
            c.wait_active_clean(timeout=clean_timeout)
            row["time_to_active_clean_s"] = round(
                time.time() - clean_t0, 2)
        except TimeoutError as e:
            row["time_to_active_clean_s"] = None
            fail.append(f"not active+clean: {e}")

        # the recovery blame: decompose the churn's recovery into the
        # control-plane ledger's stages (window = churn start through
        # active+clean, so work done while writes still flowed counts)
        blame = _recovery_blame(
            ledger_t0, _ledger_snapshot(c),
            row["time_to_active_clean_s"],
            time.time() - churn_t0)
        blame["map_epochs_churned"] = c.mon.osdmap.epoch - epoch0
        row["recovery_blame"] = blame
        if not prewarm_ec:
            # the tier-1 --scale 16 gate: every
            # stage must have recorded real time and the published
            # decomposition must account for the clean wait.  The
            # prewarm row keeps its store across revive (the churn
            # lane), so its decode stage legitimately reads zero —
            # gate only the plain row.
            zero = [s for s in BLAME_STAGES
                    if blame["stages_raw_s"].get(s, 0.0) <= 0.0]
            if zero:
                fail.append(f"recovery_blame stages never ran: {zero}")
            ttac = row["time_to_active_clean_s"]
            if ttac:
                total = sum(blame.get(s, 0.0) for s in BLAME_STAGES) \
                    + blame.get("other_s", 0.0)
                if abs(total - ttac) > 0.1 * ttac:
                    fail.append(
                        f"recovery_blame decomposition {total} "
                        f"off time_to_active_clean {ttac} by >10%")
            if blame.get("remote_lists", 0) <= 0:
                fail.append("recovery_blame saw no remote collection "
                            "lists (re-peer scan accounting dead)")

        # zero acked loss: every acked write reads back intact
        lost = 0
        for name in acked:
            try:
                if io.read(name, len(payload)) != payload:
                    lost += 1
            except (TimedOut, RadosError):
                lost += 1
        row["acked_objects"] = len(acked)
        row["lost_objects"] = lost
        if not acked:
            fail.append("no write ever acked")
        if lost:
            fail.append(f"{lost}/{len(acked)} acked objects lost")

        # bit-equality: incremental adoption converged every daemon to
        # the mon's exact committed state
        mon_can = c.mon.osdmap.canonical()
        diverged = [osd.osd_id for osd in c.osds
                    if osd is not None and
                    osd.osdmap.canonical() != mon_can]
        row["maps_bit_equal"] = not diverged
        if diverged:
            fail.append(f"osd maps diverged from mon: {diverged}")

        # the map-distribution ledger + its gates
        st = c.mon.map_stats()
        epochs = max(1, st["epochs_committed"])
        shipped = st["bytes"]["shipped"]
        row["map_epochs"] = st["epochs_committed"]
        row["map_fulls"] = st["sends"]["full"]
        row["map_incrementals"] = st["sends"]["inc"]
        row["map_keepalives"] = st["sends"]["keepalive"]
        row["map_bytes_shipped"] = shipped
        row["map_bytes_per_epoch"] = round(shipped / epochs, 1)
        row["map_full_equiv_bytes"] = st["bytes"]["full_equiv"]
        row["map_bytes_ratio"] = st["bytes_saved_ratio"]
        row["map_batched_mutations"] = st["batched_mutations"]
        row["mon_commit_ms_avg"] = st["commit"]["avg_ms"]
        if (st["bytes_saved_ratio"] or 0) < min_ratio:
            fail.append(f"map bytes ratio {st['bytes_saved_ratio']} "
                        f"< {min_ratio} (incremental publish not "
                        f"saving vs full-publish baseline)")
        if st["sends"]["keepalive"] <= 0:
            fail.append("no heartbeat keepalive was served (have_"
                        "epoch path dead: every tick pulls a map)")
        # device-plane provenance: the scale row carries
        # the host launch/compile ledger like every bench row
        from ..ops.profiler import device_profiler
        row["launch_ledger"] = device_profiler().bench_summary()
        # wire-plane provenance: the scale row carries the
        # messenger ledger beside recovery_blame — reactor lag and
        # dispatch-queue percentiles, per-peer bytes, reconnects — so
        # a slow boot-RT ships with its own wire explanation
        from ..msg.msgr_ledger import msgr_ledger
        mled = msgr_ledger().bench_summary()
        row["msgr_ledger"] = mled
        for k in ("reactor_lag_ms_p50", "reactor_lag_ms_p99",
                  "qwait_ms_p50", "qwait_ms_p99"):
            if mled.get(k) is None:
                fail.append(f"msgr_ledger {k} never populated "
                            f"(wire-plane recorder dead)")
        if not mled.get("peer_bytes"):
            fail.append("msgr_ledger saw no per-peer traffic")
        if "reconnects" not in mled:
            fail.append("msgr_ledger reconnects missing")
        if prewarm_ec:
            # compile-stall gates: with the boot prewarm + persistent
            # cache, the armed stall injection must never have fired
            # (zero compile stalls), the mon must never have raised
            # COMPILE_STORM, and the EC lane must actually have
            # written through the churn
            ec_acked = 0
            while not ec_acked_q.empty():
                ec_acked_q.get()
                ec_acked += 1
            prof = device_profiler()
            ledger = row["launch_ledger"]
            row["ec_acked_objects"] = ec_acked
            row["prewarm"] = prof.prewarm_summary()
            row["ec_compile_stalls"] = ledger.get("compile_stalls", 0)
            _rc, health = c.mon.handle_command({"prefix": "health"})
            storm = (health.get("checks") or {}).get("COMPILE_STORM")
            row["compile_storm"] = storm is not None
            if not ec_acked:
                fail.append("prewarm churn lane: no EC write acked")
            if row["prewarm"].get("buckets", 0) <= 0:
                fail.append("prewarm ran no buckets (boot hook dead)")
            if row["ec_compile_stalls"]:
                cold = [r["bucket"] for r in
                        prof.compile_ledger()["buckets"]
                        if r.get("count") and not r.get("prewarmed")
                        and not r.get("cache_hit")]
                row["cold_buckets"] = cold
                fail.append(
                    f"{row['ec_compile_stalls']} compile stalls with "
                    f"prewarm on (runtime launches hit cold buckets "
                    f"the boot prewarm should have covered: {cold})")
            if storm is not None:
                fail.append(f"COMPILE_STORM with prewarm on: "
                            f"{storm.get('summary')}")
    row["ok"] = not fail
    if fail:
        row["failures"] = fail
    print(json.dumps(row), flush=True)
    if fail:
        print(f"# cluster_bench --scale FAILED: {fail}",
              file=sys.stderr)
        return 1
    return 0


def _main_processes(args) -> int:
    """Process-topology twin of the SAME matrix.  Per-OSD conf must
    ride the spawn command line, so rows whose batch window differs
    get their own cluster; the batched-launch counters live in other
    processes and are not reported (each row's kernel launches and
    mesh plane are read through the OSDs' admin sockets)."""
    import tempfile

    from ..tools.proc_cluster import ProcCluster

    by_window: dict[float, list] = {}
    for name, profile, window in _matrix(args):
        by_window.setdefault(window, []).append((name, profile, window))
    for window, rows in by_window.items():
        conf = {"tpu_batch_window_ms": window} if window else {}
        with ProcCluster(n_osds=args.osds,
                         objectstore=args.objectstore,
                         conf=conf, mesh_devices=args.mesh,
                         asok_dir=tempfile.mkdtemp(prefix="cbench_asok_"),
                         device=args.device) as c:
            client = c.client()
            _setup_profiles(client, mesh=args.mesh is not None)
            for name, profile, w in rows:
                _bench_row(c, client, args, name, profile, w,
                           {"topology": "processes"})
    return 0


if __name__ == "__main__":
    sys.exit(main())

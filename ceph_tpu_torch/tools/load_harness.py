"""High-concurrency load harness: tail latency and QoS as first-class,
gated metrics (reference `rados bench` + qa/tasks/radosbench.py crossed
with the dmclock QoS test matrix).

Throughput benches (cluster_bench.py) answer "how fast"; production
serving is ruled by p99.  This harness drives million-client-SHAPED
load — many concurrent client sessions, mixed read/write, Zipf-skewed
hot objects, burst arrival schedules — over raw rados, RBD and RGW S3,
records every op's end-to-end latency, and pulls per-stage latency
from the op tracker's histograms so a p99/p999 regression lands on a
STAGE (queue wait, encode launch vs materialize, sub-write ack,
commit), not a blob.  The QoS scenarios make the mClock scheduler's
isolation claim falsifiable: a greedy tenant must not move a
well-behaved tenant's p99 by more than a bounded factor.

One JSON line per scenario (BENCH-artifact compatible, so BENCH_r0N
rounds can carry p99 trajectories):

  python -m ceph_tpu_torch.tools.load_harness --scenario rados --clients 64
  python -m ceph_tpu_torch.tools.load_harness --scenario qos-sim
  python -m ceph_tpu_torch.tools.load_harness --scenario all --seconds 5
  python -m ceph_tpu_torch.tools.load_harness --scenario degraded-read \
      --device cpu

Scenarios: rados | rbd | s3 | qos-sim | qos-sim-recovery |
qos-cluster | ec-pg-sweep | degraded-read | s3-shard-sweep | all.  The qos-sim rows run the mClock dequeuer in
VIRTUAL time (deterministic, no cluster, milliseconds of wall clock)
— they are the tier-1-gated isolation proof; the cluster scenarios
exercise the same claim end to end and run under the `slow` marker.

Every cluster and EC backend the harness builds runs its codecs on
`device` (`--device`: the card, "cuda", by default; "cpu" runs the
kernels' plain versions); asking for the card without a GPU raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from ..common.perf_counters import (LATENCY_QUANTILES,
                                    percentiles_from_samples,
                                    quantile_from_cumulative)
from ..osd.scheduler import (MCLOCK_PROFILES, ClientProfile,
                             MClockScheduler)
from .latency import LatencyRecorder, ZipfSampler, burst_gaps

# QoS isolation bound: the harness (and bench.py --smoke) assert a
# greedy tenant moves a well-behaved tenant's p99 queue wait by no
# more than this factor.  The sim is deterministic; 2x leaves room
# for the one-service-time quantization a reservation can't remove.
QOS_ISOLATION_MAX = 2.0


# -- per-stage percentile extraction (the tracing histograms) ---------------

def merge_stage_histograms(perf_dumps) -> dict[str, list]:
    """Merge `lat_<stage>` histogram buckets across daemons' `perf
    dump` payloads (all histograms share the same le axis, so the
    cumulative columns add): {stage: [[le, cum], ..., ['+Inf', n]]}.
    Accepts the exact dict `perf dump` returns — works in-process
    (osd.cct.perf.dump()) and over the asok alike.

    Beyond the OpTracker's op-timeline stages this also sweeps up the
    device-plane series on the same DEFAULT_LAT_BUCKETS axis: the
    host launch queue's `ec_batch_wait` and the flight recorder's
    `launch_submit` / `launch_device` / `launch_queue_wait`
    (ops/profiler.py) — so per-stage blame decomposes a write's tail
    BELOW the host boundary (queue wait vs device time vs compile)."""
    merged: dict[str, list] = {}
    for dump in perf_dumps:
        for counters in dump.values():
            if not isinstance(counters, dict):
                continue
            for key, val in counters.items():
                if not key.startswith("lat_") or \
                        not isinstance(val, dict) or \
                        "buckets" not in val:
                    continue
                stage = key[len("lat_"):]
                if stage not in merged:
                    merged[stage] = [[le, cum] for le, cum
                                     in val["buckets"]]
                else:
                    have = merged[stage]
                    for i, (_le, cum) in enumerate(val["buckets"]):
                        have[i][1] += cum
    return merged


def stage_quantiles(perf_dumps, unit_ms: bool = True) -> dict:
    """{stage: {count, p50/p95/p99/p999}} from merged tracing
    histograms — the "blame lands on a stage" payload."""
    scale = 1e3 if unit_ms else 1.0
    suffix = "_ms" if unit_ms else "_s"
    out = {}
    for stage, buckets in merge_stage_histograms(perf_dumps).items():
        total = buckets[-1][1]
        if not total:
            continue
        row = {"count": total}
        for q, label in LATENCY_QUANTILES:
            est = quantile_from_cumulative(buckets, q)
            row[f"{label}{suffix}"] = round(est[0] * scale, 4) \
                if est else None
        out[stage] = row
    return out


def cluster_stage_quantiles(cluster) -> dict:
    """Per-stage percentiles aggregated over every live OSD of an
    in-process Cluster (tools/vstart.py)."""
    return stage_quantiles(
        osd.cct.perf.dump() for osd in cluster.osds if osd is not None)


# -- mixed-workload drivers -------------------------------------------------

class WorkloadSpec:
    """One scenario's knobs (shared by the rados/rbd/s3 drivers)."""

    def __init__(self, clients: int = 32, seconds: float = 3.0,
                 size: int = 64 << 10, read_frac: float = 0.5,
                 n_objects: int = 512, zipf_alpha: float = 1.1,
                 rate: float = 0.0, burst_factor: float = 4.0,
                 burst_every: int = 0, burst_len: int = 0,
                 sessions_per_client: int = 1, seed: int = 1):
        self.clients = clients
        self.seconds = seconds
        self.size = size
        self.read_frac = read_frac
        self.n_objects = n_objects
        self.zipf_alpha = zipf_alpha
        self.rate = rate                  # per-session ops/sec (0 = closed loop)
        self.burst_factor = burst_factor
        self.burst_every = burst_every
        self.burst_len = burst_len
        # open-loop only: each worker thread multiplexes this many
        # logical client sessions, each with its own arrival schedule
        # — thousands of client sessions without thousands of Python
        # threads (the million-client SHAPE at harness scale)
        self.sessions_per_client = max(1, sessions_per_client)
        self.seed = seed

    def meta(self) -> dict:
        return {"clients": self.clients, "seconds": self.seconds,
                "sessions": self.clients * self.sessions_per_client,
                "obj_size": self.size, "read_frac": self.read_frac,
                "n_objects": self.n_objects,
                "zipf_alpha": self.zipf_alpha,
                "rate_per_session": self.rate,
                "burst": [self.burst_factor, self.burst_every,
                          self.burst_len]}


def _run_workers(spec: WorkloadSpec, make_op) -> LatencyRecorder:
    """Drive `spec.clients` concurrent sessions for `spec.seconds`.
    make_op(worker_idx) -> op(is_read, obj_idx) callable; every call
    is timed into the shared recorder, exceptions bucket by type.
    Arrival pacing: closed loop by default; with spec.rate, each
    session follows an open-loop Poisson/burst schedule (ops whose
    slot already passed fire immediately — the backlogged-queue shape
    a real burst produces)."""
    lat = LatencyRecorder()
    zipf = ZipfSampler(spec.n_objects, spec.zipf_alpha, spec.seed)
    stop_at = [0.0]

    def worker(widx: int) -> None:
        import heapq
        rng = np.random.default_rng(spec.seed + 1000 + widx)
        sampler = zipf.spawn(spec.seed + 2000 + widx)
        op = make_op(widx)
        # one arrival schedule per logical session; the worker fires
        # whichever session is due next (earliest-deadline heap)
        nsess = spec.sessions_per_client if spec.rate > 0 else 1
        gaps = [burst_gaps(spec.rate, 1 << 30, spec.burst_factor,
                           spec.burst_every, spec.burst_len,
                           seed=spec.seed + 3000 + widx * 10007 + s)
                for s in range(nsess)]
        t_start = time.perf_counter()
        due = [(t_start + next(gaps[s]), s) for s in range(nsess)] \
            if spec.rate > 0 else None
        if due:
            heapq.heapify(due)
        while True:
            now = time.perf_counter()
            if now >= stop_at[0]:
                return
            if due is not None:
                next_due, sess = heapq.heappop(due)
                if next_due > now:
                    time.sleep(min(next_due - now,
                                   max(0.0, stop_at[0] - now)))
                    if time.perf_counter() >= stop_at[0]:
                        return
                heapq.heappush(due, (next_due + next(gaps[sess]),
                                     sess))
            is_read = rng.random() < spec.read_frac
            obj = sampler.draw()
            t0 = time.perf_counter()
            try:
                op(is_read, obj)
                lat.record(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 - bucketed, reported
                lat.error(e)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(spec.clients)]
    stop_at[0] = time.perf_counter() + spec.seconds
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lat


def run_rados_mixed(cluster, client, pool: str,
                    spec: WorkloadSpec, qos_class: str | None = None
                    ) -> dict:
    """Mixed read/write over raw rados.  Objects are pre-seeded so
    reads never miss; writes overwrite (the hot-object overwrite
    pattern the extent cache and batch window exist for)."""
    payload = np.random.default_rng(5).integers(
        0, 256, spec.size, dtype=np.uint8).tobytes()
    seed_io = client.open_ioctx(pool)
    for i in range(spec.n_objects):
        seed_io.write_full(f"h_{i}", payload)

    def make_op(widx: int):
        io = client.open_ioctx(pool)
        if qos_class:
            io.set_qos_class(qos_class)

        def op(is_read: bool, obj: int) -> None:
            if is_read:
                io.read(f"h_{obj}", spec.size)
            else:
                io.write_full(f"h_{obj}", payload)
        return op

    lat = _run_workers(spec, make_op)
    row = {"metric": "harness_rados_mixed", "pool": pool,
           **spec.meta(), **lat.summary(),
           "stages": cluster_stage_quantiles(cluster)}
    return row


def run_rbd_mixed(cluster, client, pool: str, spec: WorkloadSpec
                  ) -> dict:
    """Mixed block I/O over RBD: one image per client session (the
    many-VMs shape), Zipf-hot blocks inside each image."""
    from ..rbd import RBD, Image
    io = client.open_ioctx(pool)
    rbd = RBD(io)
    block = 1 << 16
    blocks_per_img = max(4, spec.n_objects // max(spec.clients, 1))
    img_size = blocks_per_img * block
    payload = np.random.default_rng(6).integers(
        0, 256, spec.size, dtype=np.uint8).tobytes()
    for w in range(spec.clients):
        rbd.create(f"hl_img_{w}", img_size)

    def make_op(widx: int):
        img = Image(client.open_ioctx(pool), f"hl_img_{widx}")

        def op(is_read: bool, obj: int) -> None:
            off = (obj % blocks_per_img) * block
            if is_read:
                img.read(off, min(spec.size, block))
            else:
                img.write(off, payload[:min(spec.size, block)])
        return op

    spec_blocks = WorkloadSpec(**{**spec.__dict__,
                                  "n_objects": blocks_per_img})
    lat = _run_workers(spec_blocks, make_op)
    return {"metric": "harness_rbd_mixed", "pool": pool,
            **spec_blocks.meta(), **lat.summary(),
            "stages": cluster_stage_quantiles(cluster)}


def run_s3_mixed(cluster, client, spec: WorkloadSpec) -> dict:
    """Mixed PUT/GET over the RGW S3 gateway (SigV4-signed raw HTTP,
    the full client->gateway->rados path)."""
    import urllib.request

    from ..rgw import S3Gateway, sigv4
    creds = ("loadkey", "loadsecret")
    gw = S3Gateway(client, creds={creds[0]: creds[1]})
    host = f"{gw.addr[0]}:{gw.addr[1]}"
    base = f"http://{host}"

    def request(method: str, path: str, body: bytes = b"") -> None:
        headers = {"host": host}
        headers.update(sigv4.sign_request(
            method, path, "", headers, body, creds[0], creds[1]))
        req = urllib.request.Request(
            base + path, data=body if body else None,
            method=method, headers=headers)
        with urllib.request.urlopen(req, timeout=30) as resp:
            resp.read()

    payload = np.random.default_rng(8).integers(
        0, 256, spec.size, dtype=np.uint8).tobytes()
    try:
        request("PUT", "/loadbucket")
        for i in range(spec.n_objects):
            request("PUT", f"/loadbucket/h_{i}", payload)

        def make_op(widx: int):
            def op(is_read: bool, obj: int) -> None:
                if is_read:
                    request("GET", f"/loadbucket/h_{obj}")
                else:
                    request("PUT", f"/loadbucket/h_{obj}", payload)
            return op

        lat = _run_workers(spec, make_op)
    finally:
        gw.shutdown()
    return {"metric": "harness_s3_mixed", **spec.meta(),
            **lat.summary(),
            "stages": cluster_stage_quantiles(cluster)}


# -- QoS isolation: virtual-time mClock experiments -------------------------

def _sim_isolation(profiles: dict[str, ClientProfile],
                   victim_class: str, victim_rate: float,
                   greedy_class: str, greedy: bool,
                   service_rate: float, duration: float,
                   seed: int, shared_queue: bool = False) -> dict:
    """Drive an MClockScheduler in VIRTUAL time: one server of
    `service_rate` ops/sec, a victim arriving Poisson at
    `victim_rate`, and (optionally) a greedy class with an
    inexhaustible backlog.  Deterministic given the seed — no
    threads, no sleeps, no wall clock — so the isolation bound can be
    asserted in tier-1 without flake.  shared_queue collapses both
    tenants into one scheduler class — the single-FIFO behavior of
    the non-mClock op path, the contrast case QoS must beat.  Returns
    the victim's queue-wait percentiles and the greedy class's served
    share."""
    sched = MClockScheduler(profiles)
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    while t < duration:
        t += float(rng.exponential(1.0 / victim_rate))
        if t < duration:
            arrivals.append(t)
    victim_waits: list[float] = []
    served = {victim_class: 0, greedy_class: 0}
    svc = 1.0 / service_rate
    now, next_arrival = 0.0, 0
    greedy_backlog = 0

    def qclass(cls: str) -> str:
        return "client" if shared_queue else cls

    while next_arrival < len(arrivals) or not sched.empty():
        while next_arrival < len(arrivals) and \
                arrivals[next_arrival] <= now:
            ts = arrivals[next_arrival]
            sched.enqueue((victim_class, ts), qclass(victim_class),
                          now=ts)
            next_arrival += 1
        if greedy and now < duration:
            while greedy_backlog < 16:
                sched.enqueue((greedy_class, now),
                              qclass(greedy_class), now=now)
                greedy_backlog += 1
        item = sched.dequeue(now=now)
        if item is None:
            if next_arrival < len(arrivals):
                now = arrivals[next_arrival]
                continue
            break
        cls, ts = item
        served[cls] = served.get(cls, 0) + 1
        if cls == victim_class:
            victim_waits.append(now - ts)
        else:
            greedy_backlog -= 1
        now += svc
    pcts = percentiles_from_samples(
        victim_waits, [(0.5, "p50"), (0.99, "p99"), (0.999, "p999")])
    return {"victim_ops": len(victim_waits),
            "victim_p50_ms": round(pcts.get("p50", 0.0) * 1e3, 4),
            "victim_p99_ms": round(pcts.get("p99", 0.0) * 1e3, 4),
            "victim_p999_ms": round(pcts.get("p999", 0.0) * 1e3, 4),
            "greedy_ops": served.get(greedy_class, 0)}


def run_qos_isolation_sim(scenario: str = "tenant",
                          service_rate: float = 2000.0,
                          victim_rate: float = 200.0,
                          duration: float = 4.0,
                          seed: int = 7) -> dict:
    """The gated isolation experiment, three runs in virtual time:
    victim alone (baseline p99), victim + greedy under mClock QoS
    (must stay within QOS_ISOLATION_MAX of baseline), and victim +
    greedy with QoS neutralized (no reservation — shows the contrast
    that proves the scheduler, not the light load, kept the tail).

    scenario 'tenant': two tenant classes, the victim holding a
    reservation above its offered rate.  scenario 'recovery': the
    victim is the client class and recovery floods, using the
    balanced profile's shipped triples."""
    if scenario == "recovery":
        profiles = {c: ClientProfile(p.reservation, p.weight, p.limit)
                    for c, p in MCLOCK_PROFILES["balanced"].items()}
        victim_class, greedy_class = "client", "recovery"
        profiles[victim_class] = ClientProfile(
            reservation=victim_rate * 1.5, weight=2.0)
    else:
        victim_class, greedy_class = "tenant_victim", "tenant_greedy"
        profiles = {
            victim_class: ClientProfile(reservation=victim_rate * 1.5,
                                        weight=2.0),
            greedy_class: ClientProfile(reservation=0.0, weight=1.0),
        }
    base = _sim_isolation(profiles, victim_class, victim_rate,
                          greedy_class, False, service_rate, duration,
                          seed)
    qos = _sim_isolation(profiles, victim_class, victim_rate,
                         greedy_class, True, service_rate, duration,
                         seed)
    # contrast: both tenants through ONE FIFO class — the non-mClock
    # op path's behavior; the greedy backlog sits in front of every
    # victim arrival and the tail blows up
    raw = _sim_isolation({"client": ClientProfile(weight=1.0)},
                         victim_class, victim_rate,
                         greedy_class, True, service_rate, duration,
                         seed, shared_queue=True)
    # floor at one service time: an idle-baseline p99 below the
    # service quantum would make the ratio noise, not signal
    floor = 1e3 / service_rate
    denom = max(base["victim_p99_ms"], floor)
    ratio = max(qos["victim_p99_ms"], floor) / denom
    ratio_no_qos = max(raw["victim_p99_ms"], floor) / denom
    return {"metric": f"harness_qos_sim_{scenario}",
            "service_rate": service_rate,
            "victim_rate": victim_rate,
            "duration_s": duration,
            "victim_alone_p99_ms": base["victim_p99_ms"],
            "victim_qos_p99_ms": qos["victim_p99_ms"],
            "victim_no_qos_p99_ms": raw["victim_p99_ms"],
            "greedy_ops_qos": qos["greedy_ops"],
            "qos_isolation_ratio": round(ratio, 3),
            "no_qos_ratio": round(ratio_no_qos, 3),
            "bound": QOS_ISOLATION_MAX,
            "isolated": ratio <= QOS_ISOLATION_MAX}


def run_qos_cluster_tenants(n_osds: int = 4, clients: int = 4,
                            greedy_clients: int = 12,
                            seconds: float = 3.0,
                            size: int = 16 << 10,
                            device: str = "cuda") -> dict:
    """End-to-end tenant isolation on a live cluster: OSDs run the
    mClock op queue, the victim tenant holds a reservation, the
    greedy tenant is weight-only and floods.  Reports the victim's
    e2e p99 alone vs contended plus the schedulers' per-class serve
    counts.  Wall-clock and GIL noise make this a `slow`-marker
    experiment; the virtual-time sim is the gated bound."""
    from .vstart import Cluster
    custom = ("tenant_victim:400,4,0;"
              "tenant_greedy:0,1,0")
    with Cluster(n_osds=n_osds, device=device,
                 conf={"osd_op_queue": "mclock",
                       "osd_mclock_custom_profile": custom}) as c:
        client = c.client()
        client.create_pool("qospool", "replicated", size=3, pg_num=16)
        payload = np.random.default_rng(9).integers(
            0, 256, size, dtype=np.uint8).tobytes()
        seed_io = client.open_ioctx("qospool")
        for i in range(64):
            seed_io.write_full(f"q_{i}", payload)

        def tenant_load(qos_class: str, n_workers: int,
                        stop_at: float, lat: LatencyRecorder) -> list:
            def worker(w: int) -> None:
                io = client.open_ioctx("qospool")
                io.set_qos_class(qos_class)
                rng = np.random.default_rng(40 + w)
                while time.perf_counter() < stop_at:
                    obj = int(rng.integers(0, 64))
                    t0 = time.perf_counter()
                    try:
                        if rng.random() < 0.5:
                            io.read(f"q_{obj}", size)
                        else:
                            io.write_full(f"q_{obj}", payload)
                        lat.record(time.perf_counter() - t0)
                    except Exception as e:  # noqa: BLE001
                        lat.error(e)
            ts = [threading.Thread(target=worker, args=(w,),
                                   daemon=True)
                  for w in range(n_workers)]
            for t in ts:
                t.start()
            return ts

        # phase 1: victim alone
        alone = LatencyRecorder()
        ts = tenant_load("tenant_victim", clients,
                         time.perf_counter() + seconds, alone)
        for t in ts:
            t.join()
        # phase 2: victim + greedy flood
        contended = LatencyRecorder()
        greedy = LatencyRecorder()
        stop_at = time.perf_counter() + seconds
        ts = tenant_load("tenant_victim", clients, stop_at, contended)
        ts += tenant_load("tenant_greedy", greedy_clients, stop_at,
                          greedy)
        for t in ts:
            t.join()
        sched = {f"osd.{osd.osd_id}": osd.op_wq.dump()
                 for osd in c.osds
                 if osd is not None and osd.op_wq is not None}
        stages = cluster_stage_quantiles(c)
    a, b = alone.summary(), contended.summary()
    denom = max(a.get("p99_ms", 0.0) or 0.0, 0.05)
    ratio = (b.get("p99_ms", 0.0) or 0.0) / denom
    return {"metric": "harness_qos_cluster_tenants",
            "clients": clients, "greedy_clients": greedy_clients,
            "victim_alone": a, "victim_contended": b,
            "greedy": greedy.summary(),
            "qos_isolation_ratio": round(ratio, 3),
            "schedulers": sched, "stages": stages}


# -- CLI --------------------------------------------------------------------

# -- many-PG EC write fan-out (cross-PG continuous batching) ----------------
#
# The per-host launch queue (parallel/launch_queue.py, docs/PIPELINE.md
# "Host launch queue") exists so aggregate EC write GB/s survives PG
# fan-out: a host with hundreds of post-split PGs must not decay into
# hundreds of partial-occupancy launches.  run_many_pg_write is the
# direct-backend driver (no cluster: the measured axis is the launch
# path, not the messenger); run_ec_pg_sweep is the gated scenario —
# aggregate GB/s at growing PG counts, asserting the largest count
# keeps at least EC_PG_SWEEP_MIN_FRAC of the single-PG rate while the
# queue's occupancy counters prove the coalescing actually happened.

def run_many_pg_write(npg: int, total_objs: int, objsize: int,
                      chunk: int = 1024, k: int = 8, m: int = 3,
                      window_us: float = 50_000.0,
                      max_bytes: int = 64 << 20,
                      plugin: str = "torch", depth: int = 2,
                      device: str = "cuda") -> tuple[float, dict]:
    """Write `total_objs` objects of `objsize` bytes round-robin
    across `npg` ECBackends (each its own PG + MemStore shard set, the
    bench topology of ec_write_pipeline_k8_m3_GBps) that all share ONE
    per-host launch queue, every backend holding a dispatch-ahead
    window open.  Returns (aggregate input bytes/sec, the shared
    queue's status() — launches / runs-per-launch / occupancy /
    cross-PG mix).  The `torch` codecs and the queue run on `device`."""
    import contextlib

    from ..ec import ErasureCodePluginRegistry
    from ..osd.ec_backend import ECBackend, LocalShardBackend
    from ..osd.ec_transaction import PGTransaction
    from ..osd.ec_util import StripeInfo
    from ..osd.types import eversion_t, hobject_t, pg_t
    from ..parallel.launch_queue import ECLaunchQueue
    from ..store import MemStore
    reg = ErasureCodePluginRegistry.instance()
    queue = ECLaunchQueue(device=device, window_us=window_us,
                          max_bytes=max_bytes)
    prof = {"k": str(k), "m": str(m)}
    if plugin == "torch":
        prof["technique"] = "cauchy"
        prof["device"] = str(device)
    backends = []
    for i in range(npg):
        codec = reg.factory(plugin, dict(prof))
        store = MemStore()
        store.mount()
        backends.append(ECBackend(
            codec, StripeInfo(k * chunk, chunk),
            LocalShardBackend(store, pg_t(1, i), k + m),
            launch_queue=queue, dispatch_depth=depth,
            perf_name=f"ec.1.{i}"))
    rng = np.random.default_rng(13)
    payload = rng.integers(0, 256, objsize, dtype=np.uint8)
    acked: list[int] = []
    try:
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for b in backends:
                stack.enter_context(b.pipeline())
            for j in range(total_objs):
                txn = PGTransaction()
                txn.write(hobject_t(pool=1, name=f"o{j}"), 0, payload)
                backends[j % npg].submit_transaction(
                    txn, eversion_t(1, j // npg + 1),
                    lambda: acked.append(1))
        dt = time.perf_counter() - t0
    finally:
        queue.close()    # throwaway queue: retire its window worker
    if len(acked) != total_objs:
        raise RuntimeError(
            f"many-pg write: {len(acked)}/{total_objs} acked")
    return total_objs * objsize / dt, queue.status()


def run_ec_pg_sweep(pg_counts=(1, 8, 64), total_objs: int = 128,
                    objsize: int = 64 << 10, chunk: int = 1024,
                    passes: int = 3, min_frac: float | None = None,
                    device: str = "cuda") -> dict:
    """The gated many-PG scenario: the SAME total op count spread over
    growing PG counts; every fan-out count's aggregate GB/s must reach
    at least `min_frac` (env EC_PG_SWEEP_MIN_FRAC, default 0.8) of the
    same-pass single-PG rate in its best paired pass — the
    continuous-batching claim, falsifiable."""
    import os
    if min_frac is None:
        min_frac = float(os.environ.get("EC_PG_SWEEP_MIN_FRAC", "0.8"))
    rates: dict[int, float] = {}
    queues: dict[int, dict] = {}
    # per-config warm pass first: the coalesced super-batch width (its
    # pow2 jit bucket) depends on (npg, objs, window timing) — an
    # uncompiled bucket hit mid-measurement gates compile time, not
    # throughput
    for npg in pg_counts:
        rates[npg], queues[npg] = run_many_pg_write(
            npg, total_objs, objsize, chunk, device=device)
    # measured passes sweep every PG count per pass; each fan-out
    # count is gated on its best PAIRED pass (its rate / the SAME
    # pass's base rate) — the box's rate wanders ~2x between passes,
    # so an unpaired best-vs-best comparison gates that wander, not
    # fan-out — and the scenario fraction is the worst count's best
    # paired showing
    best_frac = {n: 0.0 for n in pg_counts[1:]}
    for _ in range(passes):
        row = {}
        for npg in pg_counts:
            rate, qst = run_many_pg_write(npg, total_objs, objsize,
                                          chunk, device=device)
            row[npg] = rate
            if rate > rates[npg]:
                rates[npg], queues[npg] = rate, qst
        if row[pg_counts[0]]:
            for n in pg_counts[1:]:
                best_frac[n] = max(best_frac[n],
                                   row[n] / row[pg_counts[0]])
    frac = min(best_frac.values()) if best_frac else 1.0
    top = queues[pg_counts[-1]]
    return {
        "metric": "harness_ec_pg_sweep",
        "pg_counts": list(pg_counts),
        "total_objs": total_objs,
        "objsize": objsize,
        # agg_GBps are each count's best rate across ALL passes
        # (informational); degradation_frac is each count's best
        # PAIRED pass (its rate / the same pass's base rate), so
        # recomputing the fraction from agg_GBps will NOT match on a
        # box whose rate wanders between passes — frac_method says so
        "agg_GBps": {str(n): round(rates[n] / 1e9, 3)
                     for n in pg_counts},
        "degradation_frac": round(frac, 3),
        "frac_method": "best_paired_pass",
        "min_frac": min_frac,
        "ok": frac >= min_frac,
        "launches": top["launches"],
        "runs_per_launch": top["avg_runs_per_launch"],
        "cross_pg_launches": top["cross_pg_launches"],
        "occupancy_pct": top["occupancy_pct_avg"],
    }


# -- degraded-read SLO: client reads DURING a kill/revive storm -------------
#
# The repair subsystem's acceptance metric (docs/REPAIR.md): a cluster
# that is only fast when healthy is not production, so the benchmarked
# path here is failure itself — an EC k=8,m=3 pool under a kill/revive
# storm, client reads landing THROUGH the degraded window, p99 of those
# reads published, every acked byte verified after heal (zero acked
# loss), and the reconstruct-on-read / recovery-class counters proving
# WHICH path served them.

def run_degraded_read_storm(n_osds: int = 12, objects: int = 6,
                            size: int = 32 << 10, cycles: int = 1,
                            read_passes: int = 3,
                            heartbeat: float = 1.0,
                            device: str = "cuda") -> dict:
    """Kill/revive storm on a k=8,m=3 pool with timed degraded reads.

    Box realities (see test_mesh_service's thrash notes): first writes
    pay per-PG peering + codec compile, so the write phase retries;
    heartbeats get the 1 s interval multi-daemon tests need on loaded
    boxes.  The fast CPU variant (small counts) is the tier-1 gate;
    bigger counts are the card's configuration."""
    import numpy as np

    from ..crush.hash import crush_hash32
    from ..osd.types import pg_t
    from ..osdc.objecter import TimedOut
    from ..rados.client import RadosError
    from .vstart import Cluster
    t_start = time.perf_counter()
    rng = np.random.default_rng(41)
    with Cluster(n_osds=n_osds, heartbeat_interval=heartbeat, device=device,
                 conf={"osd_ec_read_timeout": 10.0,
                       # the production-shaped configuration: rebuild
                       # units ride the mClock recovery class so client
                       # reads preempt them (docs/QOS.md)
                       "osd_op_queue": "mclock"}) as c:
        client = c.client()
        client.set_ec_profile("dr83", {
            "plugin": "torch", "k": "8", "m": "3",
            "technique": "cauchy", "stripe_unit": "1024"})
        client.create_pool("drpool", "erasure",
                           erasure_code_profile="dr83", pg_num=4)
        io = client.open_ioctx("drpool")
        acked: dict[str, bytes] = {}

        def write_some(tag: str, count: int, retries: int = 3) -> None:
            for j in range(count):
                name = f"{tag}{j}"
                payload = rng.integers(0, 256, size,
                                       dtype=np.uint8).tobytes()
                for _ in range(retries):
                    try:
                        io.write_full(name, payload)
                        acked[name] = payload
                        break
                    except (TimedOut, RadosError):
                        time.sleep(0.5)

        write_some("base", objects)
        if not acked:
            return {"metric": "harness_degraded_read", "ok": False,
                    "error": "no base object acked"}
        # victim: a DATA-shard holder (acting position < k) of the
        # first acked object's PG — its loss forces reconstruct-on-
        # read for that object, and killing a real holder (possibly
        # mid-acting) is the storm the SLO is about
        osdmap = c.osds[0].osdmap
        pool_id = [pid for pid, pl in osdmap.pools.items()
                   if pl.name == "drpool"][0]
        pgnum = osdmap.pools[pool_id].pg_num
        probe = sorted(acked)[0]
        seed = crush_hash32(probe) % pgnum
        _, acting, _, _primary = osdmap.pg_to_up_acting_osds(
            pg_t(pool_id, seed))
        lat = LatencyRecorder()
        mismatches = 0
        for cycle in range(cycles):
            victim = acting[(2 + cycle) % 8]     # a data shard holder
            c.kill_osd(victim)
            c.mark_osd_down(victim)
            # degraded window: timed reads of every acked object, plus
            # fresh writes (the storm keeps serving both directions)
            for _p in range(read_passes):
                for name, payload in sorted(acked.items()):
                    t0 = time.perf_counter()
                    try:
                        got = io.read(name, len(payload))
                        lat.record(time.perf_counter() - t0)
                        if got != payload:
                            mismatches += 1
                    except Exception as e:  # noqa: BLE001
                        lat.error(e)
            write_some(f"deg{cycle}_", 2)
            c.revive_osd(victim)
            write_some(f"rev{cycle}_", 1)
        c.wait_active_clean(timeout=180)
        # zero acked loss: every acked byte readable and intact after
        # the storm heals (bounded retry sweep for map refresh)
        missing = dict(acked)
        for _ in range(3):
            for name in list(missing):
                try:
                    if io.read(name, len(missing[name])) == \
                            missing[name]:
                        del missing[name]
                    else:
                        mismatches += 1
                        del missing[name]
                except Exception:  # noqa: BLE001
                    pass
            if not missing:
                break
            time.sleep(1.0)
        # provenance: reconstruct-on-read + recovery counters summed
        # over the cluster's EC backends / daemons
        recon = timeouts = helper = rebuilt = 0
        recovery_q = 0
        for osd in c.osds:
            if osd is None:
                continue
            for cname, counters in osd.cct.perf.dump().items():
                if not isinstance(counters, dict):
                    continue
                if cname.startswith("ec."):
                    recon += int(counters.get(
                        "ec_reconstruct_reads", 0) or 0)
                    timeouts += int(counters.get(
                        "ec_read_timeouts", 0) or 0)
                    helper += int(counters.get(
                        "ec_repair_helper_bytes", 0) or 0)
                    rebuilt += int(counters.get(
                        "ec_repair_reconstructed_bytes", 0) or 0)
                elif cname == f"osd.{osd.osd_id}":
                    recovery_q += int(counters.get(
                        "recovery_queued_ops", 0) or 0)
        # per-stage blame incl. the device-plane series (ec_batch_wait
        # from the host queue, launch_device/launch_submit from the
        # flight recorder) — the row carries its own explanation
        stages = cluster_stage_quantiles(c)
        summary = lat.summary()
        # degraded-window ledger summary: how long the
        # windows this storm opened stayed open, and how many client
        # writes were acked while inside one — summed over daemons
        deg_windows = deg_acked = deg_open = 0
        deg_stage_s: dict[str, float] = {}
        for osd in c.osds:
            if osd is None:
                continue
            try:
                t = osd.pg_ledger.totals()
            except Exception:  # noqa: BLE001 - daemon mid-shutdown
                continue
            deg_windows += t.get("degraded_windows", 0)
            deg_acked += t.get("degraded_acked", 0)
            deg_open += t.get("degraded_open", 0)
            for k in ("peering_s", "scan_s", "decode_s", "push_s",
                      "throttle_s"):
                deg_stage_s[k] = round(
                    deg_stage_s.get(k, 0.0) + t.get(k, 0.0), 4)
        # wire-plane ledger: the kill/revive storm's
        # reconnect/replay rounds + reactor-lag/dispatch percentiles —
        # a degraded window that was really a starved reactor shows up
        # here instead of staying folklore
        from ..msg.msgr_ledger import msgr_ledger
        msgr_row = msgr_ledger().bench_summary()
    row = {
        "metric": "harness_degraded_read",
        "osds": n_osds, "objects_acked": len(acked),
        "cycles": cycles, "obj_size": size,
        **{f"read_{key}": val for key, val in summary.items()},
        "mismatches": mismatches,
        "unreadable": len(missing),
        "zero_acked_loss": mismatches == 0 and not missing,
        "reconstruct_reads": recon,
        "read_timeouts": timeouts,
        "repair_helper_bytes": helper,
        "repair_reconstructed_bytes": rebuilt,
        "recovery_queued_ops": recovery_q,
        "stages": stages,
        "degraded_ledger": {
            "windows_closed": deg_windows,
            "windows_open": deg_open,
            "acked_writes_degraded": deg_acked,
            "recovery_stage_s": deg_stage_s,
        },
        "msgr_ledger": msgr_row,
        "duration_s": round(time.perf_counter() - t_start, 1),
    }
    errors = summary.get("errors", 0) or 0
    row["ok"] = bool(
        row["zero_acked_loss"] and summary.get("ops", 0) and
        not errors and
        isinstance(summary.get("p99_ms"), (int, float)) and
        summary["p99_ms"] > 0 and
        recon >= 1)
    return row


# -- sharded bucket index: ingest scaling, bounded listing, reshard --------
#
# The bucket-index subsystem's acceptance gate (docs/ARCHITECTURE.md
# "Bucket index sharding & online resharding").  On this box the win
# is serialization, not device parallelism: every index mutation
# read-modify-writes its shard's whole JSON directory doc, so a
# K-entry bucket pays O(K) serialized bytes per PUT on one shard and
# O(K/8) on eight.  Leg 1 gates that scaling with the ec-pg-sweep's
# best-paired-pass rule; leg 2 gates paginated-list p99 bounded and
# flat vs key count; leg 3 reshards 1->8 under concurrent
# puts/deletes with an OSD kill/revive through the dual-write window
# and verifies the surviving key set exactly (zero lost / duplicated
# / misrouted keys).

def _prefill_index(store, bucket: str, entries: int) -> None:
    """Blow the bucket's index docs up to `entries` rows via direct
    dir_merge (one bulk RMW per shard).  The point: a PUT's index
    cost is the O(doc) RMW the shard count divides, but on an empty
    bucket the ~ms fixed per-request overhead (socket round trips,
    data-pool write) swamps it and no shard count can look faster.
    Prefilled docs restore the production shape — index work
    dominates — so the sweep measures what sharding actually buys."""
    lay = store.index.read_layout(bucket)
    meta = {"size": 0, "etag": "prefill"}
    byshard: dict = {}
    for i in range(entries):
        k = f"f{i:06d}"
        byshard.setdefault(lay.shard_oid("index", k),
                           []).append([k, meta])
    for oid, ents in byshard.items():
        store.index._cls(oid, "dir_merge", {"entries": ents})


def _shard_ingest(store, bucket: str, nshards: int, keys: int,
                  writers: int, zipf, payload: bytes,
                  prefill: int = 0) -> float:
    """Create an nshards-index bucket (no owner: quota admission is
    out of scope here) and PUT `keys` objects from `writers` threads
    — key i is fresh except every third op, which re-PUTs a Zipf-hot
    key (the skewed-overwrite traffic production sees).  Returns
    keys/sec over the measured puts (prefill excluded)."""
    store.create_bucket(bucket, shards=nshards)
    if prefill:
        _prefill_index(store, bucket, prefill)
    start = threading.Barrier(writers)

    def work(w: int) -> None:
        samp = zipf.spawn(w + 1)
        start.wait()
        for i in range(w, keys, writers):
            kid = samp.draw() if i % 3 == 0 else i
            store.put_object(bucket, f"k{kid:05d}", payload)

    threads = [threading.Thread(target=work, args=(w,))
               for w in range(writers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return keys / (time.perf_counter() - t0)


def _list_p99(store, bucket: str, page: int, repeats: int) -> float:
    """p99 (ms) of individual paginated list_objects pages over
    `repeats` full drains of the bucket."""
    lat = LatencyRecorder()
    for _ in range(repeats):
        resume = ""
        while True:
            t0 = time.perf_counter()
            ents, _cp, trunc, resume = store.list_objects(
                bucket, max_keys=page, resume=resume)
            lat.record(time.perf_counter() - t0)
            if not trunc:
                break
    return lat.summary().get("p99_ms") or 0.0


def run_s3_shard_sweep(shard_counts=(1, 4, 8), keys: int = 600,
                       writers: int = 4, passes: int = 3,
                       list_page: int = 64, zipf_alpha: float = 1.1,
                       prefill: int = 12000,
                       min_x: float | None = None,
                       p99_max_ms: float | None = None,
                       flat_factor: float | None = None,
                       device: str = "cuda") -> dict:
    """Gated sharded-bucket-index scenario; env knobs
    S3_SHARD_SWEEP_MIN_X / S3_LIST_P99_MAX_MS /
    S3_LIST_P99_FLAT_FACTOR / S3_SHARD_PREFILL."""
    import os

    from ..rados.client import RadosError
    from .vstart import Cluster
    if min_x is None:
        min_x = float(os.environ.get("S3_SHARD_SWEEP_MIN_X", "2.0"))
    if p99_max_ms is None:
        p99_max_ms = float(os.environ.get("S3_LIST_P99_MAX_MS",
                                          "200.0"))
    if flat_factor is None:
        flat_factor = float(os.environ.get("S3_LIST_P99_FLAT_FACTOR",
                                           "3.0"))
    prefill = int(os.environ.get("S3_SHARD_PREFILL", str(prefill)))
    t_start = time.perf_counter()
    rng = np.random.default_rng(17)
    payload = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    base = shard_counts[0]
    top = shard_counts[-1]
    # measured puts per ingest: enough for a stable rate, few enough
    # that 4 rounds x len(shard_counts) buckets stay inside a CI
    # budget — the doc-RMW cost prefill restores is per-put, so the
    # put count does not change the signal, only the noise floor
    ingest_keys = max(writers * 25, keys // 4)
    with Cluster(n_osds=4, device=device) as c:
        from ..rgw.store import RGWStore
        st = RGWStore(c.client())
        zipf = ZipfSampler(ingest_keys, zipf_alpha, seed=3)

        # leg 1 — ingest scaling over prefilled buckets (see
        # _prefill_index: shard count divides the O(doc) index RMW,
        # which only dominates once docs carry a production-sized
        # entry count).  Warm pass per count first (pool peering +
        # the buckets-doc working set), then `passes` measured
        # sweeps; each fan-out count is gated on its best PAIRED
        # pass (its rate / the SAME pass's base rate) because the
        # box's absolute rate wanders ~2x between passes (the
        # ec-pg-sweep rule)
        rates: dict[int, float] = {}
        for n in shard_counts:
            rates[n] = _shard_ingest(st, f"sww{n}", n, ingest_keys,
                                     writers, zipf, payload,
                                     prefill=prefill)
        best_x = {n: 0.0 for n in shard_counts[1:]}
        for p in range(passes):
            row = {}
            for n in shard_counts:
                rate = _shard_ingest(st, f"swp{p}n{n}", n,
                                     ingest_keys, writers, zipf,
                                     payload, prefill=prefill)
                row[n] = rate
                rates[n] = max(rates[n], rate)
            if row[base]:
                for n in shard_counts[1:]:
                    best_x[n] = max(best_x[n], row[n] / row[base])
        ingest_ok = best_x.get(top, 1.0) >= min_x

        # leg 2 — paginated listing: p99 per page bounded, and flat
        # between a small bucket and one 4x its key count at the
        # same (top) shard count — what the cls parsed-doc cache and
        # the gateway continuation-cursor cache buy (without them a
        # page costs one full-doc parse per shard and the ratio
        # tracks key count).  Both buckets are dir_merge-prefilled
        # (listing never touches data objects, only index docs).
        # Paired per round for the wander reason above; the
        # denominator floor keeps a microsecond-fast small-bucket
        # page from failing the ratio on noise.
        nlarge = st.bucket_stats(f"swp{passes - 1}n{top}")["objects"]
        nsmall = max(list_page, nlarge // 4)
        st.create_bucket("swlsmall", shards=top)
        _prefill_index(st, "swlsmall", nsmall)
        large_p99 = flat_ratio = float("inf")
        for _ in range(3):
            p99_s = _list_p99(st, "swlsmall", list_page, repeats=3)
            p99_l = _list_p99(st, f"swp{passes - 1}n{top}", list_page,
                              repeats=3)
            large_p99 = min(large_p99, p99_l)
            flat_ratio = min(flat_ratio, p99_l / max(p99_s, 0.5))
        list_ok = large_p99 <= p99_max_ms and flat_ratio <= flat_factor

        # leg 3 — online reshard 1->top under concurrent writers with
        # an OSD kill/revive through the dual window.  The marker is
        # durable, so the killed copy resumes from sweep(); writers
        # retry through the outage and the final key set must match
        # the acked history exactly.
        st.create_bucket("swre", shards=1)
        npre = keys // 2
        for i in range(npre):
            st.put_object("swre", f"pre{i:05d}", payload)
        expected = {f"pre{i:05d}" for i in range(npre)}
        acked_put: set[str] = set()
        acked_del: set[str] = set()
        uncertain: set[str] = set()
        write_errors = [0]
        mu = threading.Lock()

        def attempt(fn, *a, absent_ok: bool = False) -> bool:
            from ..rgw.store import RGWError
            for i in range(5):
                try:
                    fn(*a)
                    return True
                except RGWError as e:
                    # a delete whose FIRST try timed out ambiguously
                    # may find the key already gone on retry
                    if absent_ok and e.status == 404 and i > 0:
                        return True
                    return False
                except Exception:  # noqa: BLE001 — outage window
                    time.sleep(0.3)
            return False

        def churn(w: int) -> None:
            for i in range(keys // 4):
                k = f"w{w}_{i:04d}"
                ok_put = attempt(st.put_object, "swre", k, payload)
                with mu:
                    (acked_put if ok_put else uncertain).add(k)
                    if not ok_put:
                        write_errors[0] += 1
                if ok_put and i % 3 == 2:
                    ok_del = attempt(st.delete_object, "swre", k,
                                     absent_ok=True)
                    with mu:
                        (acked_del if ok_del else uncertain).add(k)
                        if not ok_del:
                            write_errors[0] += 1

        st.resharder.start("swre", top)
        churners = [threading.Thread(target=churn, args=(w,))
                    for w in range(2)]
        for t in churners:
            t.start()
        time.sleep(0.1)
        victim = 3
        c.kill_osd(victim)
        c.mark_osd_down(victim)
        st.reshard_sweep()          # interrupted mid-copy (or errors)
        time.sleep(0.4)
        c.revive_osd(victim)
        resumed = 0
        for _ in range(60):
            sw = st.reshard_sweep()
            resumed += sw.get("resumed", 0)
            if not st.reshard_status("swre").get("reshard"):
                break
            time.sleep(0.3)
        for t in churners:
            t.join()
        # writers may have raced past the cutover; bounded extra
        # sweeps drive any still-live marker to a final state before
        # the audit (a stuck marker fails reshard_ok below)
        for _ in range(20):
            if not st.reshard_status("swre").get("reshard"):
                break
            st.reshard_sweep()
            time.sleep(0.3)
        c.wait_active_clean(timeout=120)
        expected |= acked_put
        expected -= acked_del
        expected -= uncertain
        listed: list[str] = []
        resume = ""
        while True:
            ents, _cp, trunc, resume = st.list_objects(
                "swre", max_keys=100, resume=resume)
            listed.extend(k for k, _m in ents)
            if not trunc:
                break
        got = set(listed) - uncertain
        misrouted = 0
        for k in got:
            try:
                st.index.get("swre", "index", k)
            except RadosError:
                misrouted += 1
        stat = st.bucket_stats("swre")
        reshard = {
            "shards": stat["shards"], "gen": stat["gen"],
            "resumed_sweeps": resumed,
            "expected": len(expected), "listed": len(got),
            "lost": len(expected - got),
            "extra": len(got - expected),
            "duplicated": len(listed) - len(set(listed)),
            "misrouted": misrouted,
            "uncertain": len(uncertain),
            "write_errors": write_errors[0],
        }
        reshard_ok = (stat["shards"] == top and
                      not stat["reshard"] and
                      reshard["lost"] == 0 and
                      reshard["extra"] == 0 and
                      reshard["duplicated"] == 0 and
                      misrouted == 0)
    return {
        "metric": "harness_s3_shard_sweep",
        "shard_counts": list(shard_counts), "keys": keys,
        "ingest_keys": ingest_keys, "prefill": prefill,
        "writers": writers,
        "ingest_keys_per_s": {str(n): round(rates[n], 1)
                              for n in shard_counts},
        # speedup_x is each count's best PAIRED pass (vs the same
        # pass's base rate) — recomputing from ingest_keys_per_s
        # (best across ALL passes) will not match on a wandering box
        "speedup_x": {str(n): round(best_x[n], 3)
                      for n in shard_counts[1:]},
        "frac_method": "best_paired_pass", "min_x": min_x,
        "ingest_ok": ingest_ok,
        "list_p99_ms": round(large_p99, 3),
        "list_flat_ratio": round(flat_ratio, 3),
        "list_keys": {"small": nsmall, "large": nlarge},
        "p99_max_ms": p99_max_ms, "flat_factor": flat_factor,
        "list_ok": list_ok,
        "reshard": reshard, "reshard_ok": reshard_ok,
        "duration_s": round(time.perf_counter() - t_start, 1),
        "ok": ingest_ok and list_ok and reshard_ok,
    }


def _emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="load_harness")
    ap.add_argument("--scenario", default="all",
                    choices=("rados", "rbd", "s3", "qos-sim",
                             "qos-sim-recovery", "qos-cluster",
                             "ec-pg-sweep", "degraded-read",
                             "s3-shard-sweep", "all"))
    ap.add_argument("--cycles", type=int, default=1,
                    help="degraded-read: kill/revive cycles")
    ap.add_argument("--read-passes", type=int, default=3,
                    help="degraded-read: timed read sweeps per "
                         "degraded window")
    ap.add_argument("--pg-counts", default="1,8,64",
                    help="ec-pg-sweep: comma-separated PG fan-outs")
    ap.add_argument("--shard-counts", default="1,4,8",
                    help="s3-shard-sweep: comma-separated bucket "
                         "index shard counts (first is the base)")
    ap.add_argument("--shard-keys", type=int, default=600,
                    help="s3-shard-sweep: keys ingested per bucket")
    ap.add_argument("--clients", type=int, default=32,
                    help="concurrent client sessions")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--size", type=int, default=64 << 10)
    ap.add_argument("--read-frac", type=float, default=0.5)
    ap.add_argument("--objects", type=int, default=256)
    ap.add_argument("--zipf-alpha", type=float, default=1.1)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="per-session open-loop ops/sec (0=closed loop)")
    ap.add_argument("--sessions", type=int, default=1,
                    help="logical client sessions multiplexed per "
                         "worker thread (open-loop only): "
                         "--clients 50 --sessions 100 --rate 2 = "
                         "5000 clients' worth of arrivals")
    ap.add_argument("--burst-every", type=int, default=0)
    ap.add_argument("--burst-len", type=int, default=0)
    ap.add_argument("--burst-factor", type=float, default=4.0)
    ap.add_argument("--osds", type=int, default=4)
    ap.add_argument("--ec", action="store_true",
                    help="EC k=8,m=3 pool for the rados scenario")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the clusters' and backends' EC codecs "
                         "run (default: the card; the qos-sim scenarios "
                         "use none)")
    args = ap.parse_args(argv)

    scenarios = [args.scenario] if args.scenario != "all" else \
        ["qos-sim", "qos-sim-recovery", "ec-pg-sweep", "rados", "rbd",
         "s3"]
    spec = WorkloadSpec(
        clients=args.clients, seconds=args.seconds, size=args.size,
        read_frac=args.read_frac, n_objects=args.objects,
        zipf_alpha=args.zipf_alpha, rate=args.rate,
        burst_factor=args.burst_factor, burst_every=args.burst_every,
        burst_len=args.burst_len, sessions_per_client=args.sessions)

    rc = 0
    sims = [s for s in scenarios if s.startswith("qos-sim")]
    if len(sims) < len(scenarios):
        # the sims run in virtual time on no device; every other
        # scenario builds its codecs on --device: no GPU for "cuda",
        # raise here
        from .. import resolve_device
        resolve_device(args.device)
    for s in sims:
        _emit(run_qos_isolation_sim(
            "recovery" if s == "qos-sim-recovery" else "tenant"))
    if "ec-pg-sweep" in scenarios:
        counts = tuple(int(t) for t in args.pg_counts.split(","))
        row = run_ec_pg_sweep(pg_counts=counts,
                              total_objs=min(args.objects, 256),
                              objsize=args.size, device=args.device)
        _emit(row)
        if not row["ok"]:
            # record the gate failure but keep running: under
            # --scenario all the remaining scenarios still emit their
            # rows (a wall-clock-sensitive sweep dip must not silently
            # skip the rados/rbd/s3 runs)
            print(f"ec-pg-sweep: aggregate GB/s degraded to "
                  f"{row['degradation_frac']} of the 1-PG rate "
                  f"(min {row['min_frac']})", file=sys.stderr)
            rc = 1
    if "degraded-read" in scenarios:
        row = run_degraded_read_storm(
            n_osds=max(args.osds, 12), objects=min(args.objects, 32),
            size=args.size, cycles=args.cycles,
            read_passes=args.read_passes, device=args.device)
        _emit(row)
        if not row.get("ok"):
            # the degraded-read SLO is a gate: reads during the storm
            # must complete via reconstruct-on-read with zero acked
            # loss (rc != 0 fails tier-1)
            print(f"degraded-read: gate failed "
                  f"(zero_acked_loss={row.get('zero_acked_loss')}, "
                  f"errors={row.get('read_errors')}, "
                  f"reconstructs={row.get('reconstruct_reads')}, "
                  f"p99={row.get('read_p99_ms')})", file=sys.stderr)
            rc = 1
    if "s3-shard-sweep" in scenarios:
        counts = tuple(int(t) for t in args.shard_counts.split(","))
        row = run_s3_shard_sweep(shard_counts=counts,
                                 keys=args.shard_keys,
                                 device=args.device)
        _emit(row)
        if not row["ok"]:
            # the sharded-index gate: ingest must scale with shard
            # count, merged listing must stay bounded/flat, and an
            # interrupted online reshard must converge losslessly
            print(f"s3-shard-sweep: gate failed "
                  f"(ingest_ok={row['ingest_ok']} "
                  f"speedup={row['speedup_x']}, "
                  f"list_ok={row['list_ok']} "
                  f"p99={row['list_p99_ms']}ms "
                  f"flat={row['list_flat_ratio']}, "
                  f"reshard_ok={row['reshard_ok']} "
                  f"{row['reshard']})", file=sys.stderr)
            rc = 1
    if "qos-cluster" in scenarios:
        _emit(run_qos_cluster_tenants(
            n_osds=args.osds, clients=max(2, args.clients // 8),
            greedy_clients=args.clients, seconds=args.seconds,
            size=args.size, device=args.device))
    cluster_scenarios = [s for s in scenarios
                         if s in ("rados", "rbd", "s3")]
    if cluster_scenarios:
        if args.ec and "rados" in cluster_scenarios and args.osds < 11:
            print("--ec needs >= 11 OSDs for k=8,m=3 (pass --osds 12)",
                  file=sys.stderr)
            return 2
        from .vstart import Cluster
        with Cluster(n_osds=args.osds, device=args.device) as c:
            client = c.client()
            if "rados" in cluster_scenarios:
                if args.ec:
                    client.set_ec_profile("hl83", {
                        "plugin": "jerasure", "k": "8", "m": "3",
                        "stripe_unit": "4096"})
                    client.create_pool("hl_rados", "erasure",
                                       erasure_code_profile="hl83",
                                       pg_num=16)
                else:
                    client.create_pool("hl_rados", "replicated",
                                       size=3, pg_num=16)
                _emit(run_rados_mixed(c, client, "hl_rados", spec))
            if "rbd" in cluster_scenarios:
                client.create_pool("hl_rbd", "replicated", size=3,
                                   pg_num=16)
                _emit(run_rbd_mixed(c, client, "hl_rbd", spec))
            if "s3" in cluster_scenarios:
                _emit(run_s3_mixed(c, client, spec))
    return rc


if __name__ == "__main__":
    sys.exit(main())

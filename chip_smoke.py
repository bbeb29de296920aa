"""Drive the port (ceph_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch built for
CUDA; exits non-zero, printing no result, without them.  Builds the
CUDA kernels from ceph_tpu_torch/csrc/ (first use), then:

1. Kernels.  At the main path's shapes, every kernel entry runs on the
   card against its plain PyTorch version on the same inputs; results
   must be equal exactly (bytes and crc values).  Each entry is timed
   with CUDA events: `ms` is the median of 25 event pairs, each around
   one replay of a CUDA graph of 10 calls (after 3 warm-up calls), per
   call — the kernel without the host's launch overhead, its inputs
   resident in L2; `single_ms` the median of 25 event pairs around one
   call queued behind a spin of the card that covers the host's launch
   (the kernel plus one launch's device-side gap); `cold_ms` the same
   after a 1 GiB read that evicts the 50 MB L2, so inputs come from
   device memory (cold_ms - single_ms is what a cold L2 costs);
   `plain_ms` the median of 21 event pairs around one call of the plain
   version (its host launch gaps included).  The
   bound is the bytes it must move over the card's memory rate
   (3.35 TB/s, the H100 SXM data sheet) or its byte operations (one
   GF(2^8) multiply-add per coefficient and column, one crc table step
   per shard byte) over the int8 rate (1,979 TOP/s), whichever is
   larger.  No single PyTorch call
   computes these functions, so library_ms is null.
2. Main path.  The port's ECBackend + LocalShardBackend over MemStore,
   plugin `torch`, k=8 m=3 cauchy (the ISA-L default profile), stripe
   unit 4096 B, dispatch-ahead depth 2.  Writes: 64 objects of 4 MiB
   (RBD's default object size) in a pipeline() window, one drain per
   op (512 KiB runs per shard: the hier entry); 16 objects of 64 KiB
   (the flat entry); one batch() drain mixing both sizes (the split
   path); 8 partial 16 KiB overwrites (RMW pre-read + K1 plain encode).
   Then every object is read back and compared byte for byte, every
   object is read degraded with shards 0 and 1 failing (rebuilt by K1
   decode), parity is held against a host GF(2^8) reference on one
   object, and every valid HashInfo crc against the host crc32c of the
   stored shard bytes.  Launch counters are zeroed before each phase
   (writes, degraded reads) and must be > 0 for every kernel after it.
   The host time of the 64 big writes is split by the backend's stage
   timers, and a profiled window of 8 more writes gives the card's
   busy share.

Output: the card's name and power limit, the kernels JSON line, the
main path's throughput line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (data sheet)
INT8_OPS_PER_S = 1.979e15       # H100 SXM int8 tensor rate (data sheet)
K, M = 8, 3
STRIPE_UNIT = 4096
BIG = 4 << 20                   # 4 MiB objects
SMALL = 64 << 10                # 64 KiB objects
N_BIG, N_SMALL, N_RMW = 64, 16, 8
RMW_LEN = 16 << 10
SEED = 20261016
SPIN_CYCLES = 1_000_000         # ~0.5 ms of card clock


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def device_events(fn):
    """Run fn under torch.profiler; returns [(name, device us)] of every
    activity that ran on the card (kernels and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def event_ms(fn, warmup: int = 1, iters: int = 21) -> float:
    """Median milliseconds of one call of `fn` between a pair of CUDA
    events (the host's launch gaps inside the call included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def single_event_ms(fn, flush: torch.Tensor | None = None,
                    iters: int = 25) -> float:
    """Median milliseconds of one call of `fn` queued behind a spin of
    the card that lasts longer than the host's launch of the call; with
    `flush` (larger than L2) read first, its inputs come from device
    memory."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_event_ms(fn, calls: int = 10, samples: int = 25) -> float:
    """Median over `samples` CUDA-event pairs, each around one replay of
    a CUDA graph holding `calls` back-to-back calls of `fn`, per call:
    the kernel's time without the host's launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


class StageTimes:
    """The ECBackend perf hook: accumulates its stage timers and counters
    (inc/set/tinc) so the run can say where the host time goes."""

    def __init__(self):
        self.t: dict[str, float] = {}
        self.n: dict[str, int] = {}

    def inc(self, key, by=1):
        self.n[key] = self.n.get(key, 0) + by

    def set(self, key, value):
        self.n[key] = value

    def tinc(self, key, dt):
        self.t[key] = self.t.get(key, 0.0) + dt


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def phase_kernels(dev, bs, gf, rng) -> list[dict]:
    """Every kernel entry against its plain version at the main path's
    shapes; exact equality required."""
    gen = gf.cauchy_rs_matrix(K, M)
    enc = bs.tables_tensor(gf.product_tables(gen[K:]), dev)
    lost = (0, 1)
    survivors = tuple(s for s in range(K + M) if s not in lost)[:K]
    dec = bs.tables_tensor(gf.product_tables(
        gf.recovery_matrix(gen, K, survivors, lost)), dev)
    run = (BIG // K)                               # 512 KiB per shard
    small = 8 << 10                                # 8 KiB per shard
    data = torch.from_numpy(
        rng.integers(0, 256, (K, run), dtype=np.uint8)).to(dev)
    data_small = torch.from_numpy(
        rng.integers(0, 256, (K, small), dtype=np.uint8)).to(dev)
    cases = [
        ("gf_bitmatmul (encode, K1)", "csrc/gf_bitmatmul.cu",
         "ceph_tpu/ops/bitsliced.py:227", "gf_bitmatmul",
         lambda: bs.gf_bitmatmul(enc, data),
         lambda: bs.gf_bitmatmul_plain(enc, data), M, run, None),
        ("gf_bitmatmul (decode, K1)", "csrc/gf_bitmatmul.cu",
         "ceph_tpu/ops/bitsliced.py:227", "gf_bitmatmul",
         lambda: bs.gf_bitmatmul(dec, data),
         lambda: bs.gf_bitmatmul_plain(dec, data), len(lost), run, None),
        ("fused_hier_call (K2, 2 KiB sub-blocks)", "csrc/gf_encode_crc.cu",
         "ceph_tpu/ops/bitsliced.py:523", "fused_hier_call",
         lambda: bs.fused_hier_call(enc, data, bs.FUSED_WB),
         lambda: bs.fused_hier_call_plain(enc, data, bs.FUSED_WB),
         M, run, 4 * bs.FUSED_WB),
        ("gf_encode_with_crc_w32 (K2, 2 KiB tiles)", "csrc/gf_encode_crc.cu",
         "ceph_tpu/ops/bitsliced.py:437", "gf_encode_with_crc_w32",
         lambda: bs.gf_encode_with_crc_w32(enc, data_small, bs.FUSED_TILE),
         lambda: bs.gf_encode_with_crc_w32_plain(enc, data_small,
                                                 bs.FUSED_TILE),
         M, small, bs.FUSED_TILE),
    ]
    flush = torch.zeros(1 << 28, dtype=torch.int32, device=dev)  # 1 GiB
    rows = []
    for name, src, replaces, counter, kern, plain, r, n, block in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if block is None:
            err = max_abs_err(got, want)
            shapes_ok = got.shape == want.shape == (r, n)
        else:
            err = max(max_abs_err(got[0], want[0]),
                      max_abs_err(got[1], want[1]))
            shapes_ok = (got[0].shape == want[0].shape == (r, n) and
                         got[1].shape == want[1].shape ==
                         (K + M, n // block))
        if err != 0 or not shapes_ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {err})")
        ms = graph_event_ms(kern)
        single_ms = single_event_ms(kern)
        cold_ms = single_event_ms(kern, flush)
        plain_ms = event_ms(plain)
        nbytes = K * n + r * n + r * K * 256
        if block is not None:
            nbytes += (K + M) * (n // block) * 4
        ops = 2 * r * K * n                  # GF(2^8) multiply-adds
        if block is not None:
            ops += 2 * (K + M) * n           # one crc table step a byte
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append({"name": name, "route": "cuda",
                     "source": f"ceph_tpu_torch/{src}",
                     "replaces": replaces, "counter": counter,
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "single_ms": single_ms, "cold_ms": cold_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    del flush
    return rows


def phase_main_path(dev, rng):
    """The port's write and degraded-read path, k=8 m=3; returns
    (per-phase launch counts, throughput dict)."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry, gf
    from ceph_tpu_torch.common import crc32c
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.osd import ec_transaction as ect
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t, pg_t
    from ceph_tpu_torch.store import MemStore

    class DegradedShards(LocalShardBackend):
        down: set = set()

        def sub_read(self, shard, oid, off, length, on_done):
            if shard in self.down:
                on_done(shard, None)
                return
            super().sub_read(shard, oid, off, length, on_done)

    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": str(K), "m": str(M), "technique": "cauchy",
                  "device": str(dev)})
    sinfo = StripeInfo(stripe_width=K * STRIPE_UNIT, chunk_size=STRIPE_UNIT)
    store = MemStore()
    store.mount()
    shards = DegradedShards(store, pg_t(1, 0), K + M)
    stages = StageTimes()
    be = ECBackend(codec, sinfo, shards, dispatch_depth=2, perf=stages)
    expect: dict[str, np.ndarray] = {}
    version = [0]
    acks = []

    def oid(name):
        return hobject_t(pool=1, name=name)

    def submit(name, off, data):
        txn = PGTransaction()
        txn.write(oid(name), off, data)
        version[0] += 1
        be.submit_transaction(txn, eversion_t(1, version[0]),
                              lambda v=version[0]: acks.append(v))

    def write(name, off, data):
        submit(name, off, data)
        cur = expect.get(name, np.zeros(0, dtype=np.uint8))
        if cur.size < off + data.size:
            cur = np.concatenate(
                [cur, np.zeros(off + data.size - cur.size, np.uint8)])
        cur[off:off + data.size] = data
        expect[name] = cur

    def payload(n):
        return np.frombuffer(rng.bytes(n), dtype=np.uint8)

    big = {f"big{i}": payload(BIG) for i in range(N_BIG)}
    small = {f"small{i}": payload(SMALL) for i in range(N_SMALL)}
    mixed = {f"mixbig{i}": payload(BIG) for i in range(2)}
    mixed.update({f"mixsmall{i}": payload(SMALL) for i in range(4)})
    torch.cuda.synchronize()

    counts = {}
    # -- write path ---------------------------------------------------
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    with be.pipeline():
        for name, p in big.items():
            submit(name, 0, p)
    t_big = time.perf_counter() - t0
    expect.update({name: p.copy() for name, p in big.items()})
    write_stages = dict(stages.t)
    paths = {"big": be.fused_path}

    # device busy share over a steady window of 8 more 4 MiB writes; the
    # wall clock runs inside the profiled region, so the profiler's own
    # start-up is not counted
    window_data = {f"prof{i}": payload(BIG) for i in range(8)}
    win = {}

    def window():
        t0 = time.perf_counter()
        with be.pipeline():
            for name, p in window_data.items():
                submit(name, 0, p)
        torch.cuda.synchronize()
        win["s"] = time.perf_counter() - t0
    evs = device_events(window)
    t_win = win["s"]
    expect.update({name: p.copy() for name, p in window_data.items()})
    busy_ms = sum(us for _, us in evs) / 1e3
    kernel_ms = sum(us for name, us in evs
                    if "Memcpy" not in name and "Memset" not in name) / 1e3
    with be.pipeline():
        for name, p in small.items():
            write(name, 0, p)
    paths["small"] = be.fused_path
    launches_before = be.batched_launches
    with be.batch():
        for name, p in mixed.items():
            write(name, 0, p)
    paths["mixed"] = be.fused_path
    if be.batched_launches != launches_before + 1:
        raise AssertionError("the mixed batch did not drain as one launch")
    with be.pipeline():
        for i in range(N_RMW):
            write(f"big{i}", (1 << 20) + 1000 + 4096 * i, payload(RMW_LEN))
    torch.cuda.synchronize()
    counts["write"] = bs.launch_counts()
    if acks != list(range(1, version[0] + 1)):
        raise AssertionError("acks out of order or missing")
    if paths != {"big": "hier_lsub", "small": "w32_flat",
                 "mixed": "hier_lsub+w32_flat"}:
        raise AssertionError(f"unexpected kernel paths {paths}")

    for name, want in expect.items():
        got = be.read(oid(name))
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"read back of {name} differs")

    # parity of one object against the host GF(2^8) reference
    last = f"big{N_BIG - 1}"
    host = ec_util.encode(sinfo, codec, expect[last])
    ref = gf.gf_matvec(codec.matrix[K:], host[:K])
    for s in range(K + M):
        stored = store.read(shards.cids[s], ect.shard_oid(oid(last), s))
        want = host[s] if s < K else ref[s - K]
        if not np.array_equal(stored, want):
            raise AssertionError(f"shard {s} of {last} differs from the host "
                                 "reference encode")

    # every valid HashInfo crc against the host crc32c of the bytes
    n_crc = 0
    for name in expect:
        hinfo = shards.get_hinfo(0, oid(name))
        if not hinfo.crc_valid:
            continue
        rows = np.stack([store.read(shards.cids[s],
                                    ect.shard_oid(oid(name), s))
                         for s in range(K + M)])
        if crc32c.crc32c_rows(rows, [0xFFFFFFFF] * (K + M)) != \
                list(hinfo.cumulative_shard_hashes):
            raise AssertionError(f"HashInfo crc of {name} differs from the "
                                 "host crc32c of its shards")
        n_crc += 1
    if n_crc < N_BIG - N_RMW + N_SMALL + len(mixed):
        raise AssertionError(f"only {n_crc} objects carry a valid crc")

    # -- degraded read path -------------------------------------------
    shards.down = {0, 1}
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    nread = 0
    for name in big:
        got = be.read(oid(name))
        nread += got.size
        if not np.array_equal(got, expect[name]):
            raise AssertionError(f"degraded read of {name} differs")
    t_deg = time.perf_counter() - t0
    for name in list(small) + list(mixed):
        if not np.array_equal(be.read(oid(name)), expect[name]):
            raise AssertionError(f"degraded read of {name} differs")
    torch.cuda.synchronize()
    counts["read"] = bs.launch_counts()
    shards.down = set()

    if len(be.extent_cache) or be._projected or be._inflight:
        raise AssertionError("pipeline state did not drain")
    perf = {"write_4MiB_objects_GBps": N_BIG * BIG / t_big / 1e9,
            "write_4MiB_objects_s": t_big,
            "write_stage_s": write_stages,
            "window_wall_ms": t_win * 1e3,
            "window_device_busy_ms": busy_ms,
            "window_device_kernel_ms": kernel_ms,
            "window_device_busy_share": busy_ms / (t_win * 1e3),
            "degraded_read_4MiB_objects_GBps": nread / t_deg / 1e9,
            "degraded_read_4MiB_objects_s": t_deg,
            "objects": len(expect), "crc_checked_objects": n_crc,
            "paths": paths}
    return counts, perf


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from ceph_tpu_torch import resolve_device
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import bitsliced as bs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device("cuda")
    print(nvidia_smi_line(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})", flush=True)
    rng = np.random.default_rng(SEED)

    rows = phase_kernels(dev, bs, gf, rng)
    counts, perf = phase_main_path(dev, rng)
    for row in rows:
        phase = "read" if "decode" in row["name"] else "write"
        row["launches"] = counts[phase][row.pop("counter")]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on the "
                                 f"main path's {phase} phase")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"main_path": perf, "launch_counts": counts}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

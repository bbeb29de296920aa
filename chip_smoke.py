"""Drive the port (ceph_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and PyTorch built for
CUDA; exits non-zero, printing no result, without them.  Builds the
CUDA kernels from ceph_tpu_torch/csrc/ (first use), then:

1. Kernels.  At the main paths' shapes, every kernel entry runs on the
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
   computes these functions, so library_ms is null.  Nine rows: K1
   (encode, decode, the device entry), K2's three entries (hier, w32
   flat, and the byte entry of Pallas #6 at 8+3 x 512 KiB), K3 (one run,
   two runs) and K4 (Pallas #7's counterpart, 8 x 512 KiB -> 3, its
   default grid).
2. Main path at combine="xla".  The port's ECBackend +
   LocalShardBackend over MemStore, plugin `torch`, k=8 m=3 cauchy (the
   ISA-L default profile), stripe unit 4096 B, dispatch-ahead depth 2,
   its operating point pinned to the K2 + fold combine through an
   autotune cache file (CEPH_TPU_AUTOTUNE_CACHE, as an operator would).
   Writes: 32 objects of 4 MiB (RBD's default object size) in a
   pipeline() window, one drain per op (512 KiB runs per shard: the
   hier entry of K2, path hier_lsub); 16 objects of 64 KiB (the flat
   entry); one batch() drain mixing both sizes (the split path); 8
   partial 16 KiB overwrites (RMW pre-read + K1 plain encode).  Then
   every object is read back and compared byte for byte, every object
   is read degraded with shards 0 and 1 failing (rebuilt by K1
   decode), parity is held against a host GF(2^8) reference on one
   object, and every valid HashInfo crc against the host crc32c of the
   stored shard bytes.  Launch counters are zeroed before each phase
   (writes, degraded reads) and must be > 0 for every kernel after it.
   The host time of the big writes is split by the backend's stage
   timers, and a profiled window of 8 more writes gives the card's
   busy share.
3. Autotune sweep (phase A).  ops/autotune sweeps (wb, combine) with a
   fresh cache file: every candidate is validated bit-exactly, then
   timed; the table is printed.  A second plugin init must take the
   point from the cached row (keyed by card name, sm, torch version and
   KERNEL_GEN) with zero measurements.
4. Main path at combine="kernel" (phase B): as 2., with 64 objects of
   4 MiB and the point pinned to K3 (path hier_acc, the mixed batch
   hier_acc+w32_flat); every fused result must have an empty tail.
   Then 16 x 4 MiB writes at the point the sweep picked, and an
   interleaved A/B of 16 x 4 MiB writes per round at the two combines
   (xla, kernel, kernel, xla, xla, kernel), each on a fresh backend.
5. Benchmark (phase C): ceph_tpu_torch.tools.ec_benchmark.main with the
   reference's canonical invocation (-P k=8 -P m=3 -S 1048576 -i 1000),
   the same with --batch 32, -w decode -e 1, and -w decode -e 2 -E
   exhaustive (all 55 erasure pairs verified).  Launches are counted
   over the two encode invocations (the row of encode_chunks_device)
   and over the two decode invocations apart.
6. Byte branch (phase D): a fresh backend whose codec has _use_w32 =
   False — ceph_tpu's byte-layout write path: 16 x 4 MiB, 16 x 64 KiB
   and one mixed batch(), every drain one launch of K2's byte entry
   (path "bytes", counted as a fallback drain), the hier, flat and K3
   counters 0; then readback, degraded reads with shards 0 and 1 down,
   parity and HashInfo checks.  GB/s and stage times are printed.
7. w32_sweep (phase E): ceph_tpu_torch.tools.w32_sweep at full size
   (4 MiB a chunk), K1 and K4 over tiles of 64 KiB - 4 MiB of each row
   per block, every configuration exact before it is timed.  Then K1
   and K4 (G = 1, 2, 4, 8 lanes a strip) at their default grids over
   rows of 16 KiB - 4 MiB, checked and timed as the kernel rows are.
8. A/B (phase F): the native CPU library must have built; then
   ec_benchmark --ab (isa against torch, 1 MiB objects, per call and
   --batch 32, 1 s a side and mode) and -p isa / -p jerasure with the
   canonical invocation.

Output: the card's name and power limit, the sweep tables, the kernels
JSON line, the main paths', the benchmark's, the w32 sweep's and the
A/B's lines, and as the last line {"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": 1}} (the script drives one card).  Any
failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (data sheet)
INT8_OPS_PER_S = 1.979e15       # H100 SXM int8 tensor rate (data sheet)
K, M = 8, 3
STRIPE_UNIT = 4096
BIG = 4 << 20                   # 4 MiB objects
SMALL = 64 << 10                # 64 KiB objects
N_BIG_XLA, N_BIG_ACC, N_BIG_PICK, N_BIG_BYTES = 32, 64, 16, 16
N_SMALL, N_RMW = 16, 8
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


def graph_event_ms(fn) -> float:
    """Median over 25 CUDA-event pairs, each around one replay of a CUDA
    graph holding 10 back-to-back calls of `fn`, per call: the kernel's
    time without the host's launch overhead (w32_sweep's timer)."""
    from ceph_tpu_torch.tools.w32_sweep import graph_ms
    return graph_ms(fn, calls=10, samples=25)


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




def kernel_row(name, src, replaces, counter, phase, kern, plain, shapes,
               nbytes, ops, flush) -> dict:
    """Check one kernel entry against its plain version (exact, and the
    expected output shapes) and time both; `phase` names the main-path
    phase whose launch count the row reports."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    shapes_ok = len(got) == len(want) == len(shapes) and all(
        tuple(g.shape) == tuple(w.shape) == sh
        for g, w, sh in zip(got, want, shapes))
    if err != 0 or not shapes_ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, shapes "
                             f"{[tuple(g.shape) for g in got]})")
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda",
            "source": f"ceph_tpu_torch/{src}", "replaces": replaces,
            "counter": counter, "phase": phase, "launches": None,
            "max_abs_err": err, "ms": graph_event_ms(kern),
            "single_ms": single_event_ms(kern),
            "cold_ms": single_event_ms(kern, flush),
            "plain_ms": event_ms(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_kernels(dev, bs, gf, rng, codec) -> list[dict]:
    """Every kernel entry against its plain version at the main paths'
    shapes; exact equality required."""
    gen = gf.cauchy_rs_matrix(K, M)
    enc = bs.tables_tensor(gf.product_tables(gen[K:]), dev)
    lost = (0, 1)
    survivors = tuple(s for s in range(K + M) if s not in lost)[:K]
    dec = bs.tables_tensor(gf.product_tables(
        gf.recovery_matrix(gen, K, survivors, lost)), dev)
    run = BIG // K                                 # 512 KiB per shard
    small = 8 << 10                                # 8 KiB per shard
    bench = (1 << 20) // K                         # 1 MiB object: 128 KiB
    block = 4 * bs.FUSED_WB

    def rand(n):
        return torch.from_numpy(
            rng.integers(0, 256, (K, n), dtype=np.uint8)).to(dev)
    data, data_small, data_bench = rand(run), rand(small), rand(bench)
    # K3's two-run case: a 512 KiB run, then one of odd width front-padded
    # to the block, as the extents path lays them out
    odd = 300 * 1024 + 777
    pad = -odd % block
    data_two = torch.cat([data, torch.zeros((K, pad), dtype=torch.uint8,
                                            device=dev), rand(odd)], dim=1)
    blocks_two = [run // block, (odd + pad) // block]
    staged_one, ends_one = bs._acc_launch_args([run // block], dev)
    staged_two, ends_two = bs._acc_launch_args(blocks_two, dev)
    torch.cuda.synchronize()
    del staged_one, staged_two

    def gf_bytes(r, n):
        return K * n + r * n + r * K * 256

    def gf_ops(r, n):
        return 2 * r * K * n                 # GF(2^8) multiply-adds

    def crc_ops(n):
        return 2 * (K + M) * n               # one crc table step a byte

    n_two = data_two.shape[1]
    flush = torch.zeros(1 << 28, dtype=torch.int32, device=dev)  # 1 GiB
    rows = [
        kernel_row("gf_bitmatmul (encode, K1)", "csrc/gf_bitmatmul.cu",
                   "ceph_tpu/ops/bitsliced.py:227", "gf_bitmatmul",
                   "xla_write",
                   lambda: bs.gf_bitmatmul(enc, data),
                   lambda: bs.gf_bitmatmul_plain(enc, data), [(M, run)],
                   gf_bytes(M, run), gf_ops(M, run), flush),
        kernel_row("gf_bitmatmul (decode, K1)", "csrc/gf_bitmatmul.cu",
                   "ceph_tpu/ops/bitsliced.py:227", "gf_bitmatmul",
                   "xla_read",
                   lambda: bs.gf_bitmatmul(dec, data),
                   lambda: bs.gf_bitmatmul_plain(dec, data),
                   [(len(lost), run)], gf_bytes(len(lost), run),
                   gf_ops(len(lost), run), flush),
        kernel_row("fused_hier_call (K2, 2 KiB sub-blocks)",
                   "csrc/gf_encode_crc.cu", "ceph_tpu/ops/bitsliced.py:523",
                   "fused_hier_call", "xla_write",
                   lambda: bs.fused_hier_call(enc, data, bs.FUSED_WB),
                   lambda: bs.fused_hier_call_plain(enc, data, bs.FUSED_WB),
                   [(M, run), (K + M, run // block)],
                   gf_bytes(M, run) + (K + M) * (run // block) * 4,
                   gf_ops(M, run) + crc_ops(run), flush),
        kernel_row("gf_encode_with_crc_w32 (K2, 2 KiB tiles)",
                   "csrc/gf_encode_crc.cu", "ceph_tpu/ops/bitsliced.py:437",
                   "gf_encode_with_crc_w32", "xla_write",
                   lambda: bs.gf_encode_with_crc_w32(enc, data_small,
                                                     bs.FUSED_TILE),
                   lambda: bs.gf_encode_with_crc_w32_plain(enc, data_small,
                                                           bs.FUSED_TILE),
                   [(M, small), (K + M, small // bs.FUSED_TILE)],
                   gf_bytes(M, small) + (K + M) * (small // bs.FUSED_TILE) * 4,
                   gf_ops(M, small) + crc_ops(small), flush),
        kernel_row("gf_encode_crc_acc (K3, one 512 KiB run)",
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:539", "fused_hier_acc_call",
                   "kernel_write",
                   lambda: bs.fused_hier_acc_call(enc, data, ends_one,
                                                  bs.FUSED_WB),
                   lambda: bs.fused_hier_acc_call_plain(enc, data, ends_one,
                                                        bs.FUSED_WB),
                   [(M, run), (1, K + M)],
                   gf_bytes(M, run) + (K + M) * 4 + 8,
                   gf_ops(M, run) + crc_ops(run), flush),
        kernel_row("gf_encode_crc_acc (K3, 2 runs, one odd-width)",
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:539", "fused_hier_acc_call",
                   "kernel_write",
                   lambda: bs.fused_hier_acc_call(enc, data_two, ends_two,
                                                  bs.FUSED_WB),
                   lambda: bs.fused_hier_acc_call_plain(enc, data_two,
                                                        ends_two,
                                                        bs.FUSED_WB),
                   [(M, n_two), (2, K + M)],
                   gf_bytes(M, n_two) + 2 * (K + M) * 4 + 16,
                   gf_ops(M, n_two) + crc_ops(n_two), flush),
        kernel_row("encode_chunks_device (K1, 8 x 128 KiB)",
                   "csrc/gf_bitmatmul.cu", "ceph_tpu/ops/bitsliced.py:122",
                   "gf_bitmatmul", "bench_encode",
                   lambda: codec.encode_chunks_device(data_bench),
                   lambda: bs.gf_bitmatmul_plain(codec._enc_tables,
                                                 data_bench),
                   [(M, bench)], gf_bytes(M, bench), gf_ops(M, bench),
                   flush),
        kernel_row("gf_encode_with_crc (K2 byte entry, 2 KiB tiles)",
                   "csrc/gf_encode_crc.cu", "ceph_tpu/ops/bitsliced.py:385",
                   "gf_encode_with_crc", "bytes_write",
                   lambda: bs.gf_encode_with_crc(enc, data, bs.FUSED_TILE),
                   lambda: bs.gf_encode_with_crc_plain(enc, data,
                                                       bs.FUSED_TILE),
                   [(M, run), (K + M, run // bs.FUSED_TILE)],
                   gf_bytes(M, run) + (K + M) * (run // bs.FUSED_TILE) * 4,
                   gf_ops(M, run) + crc_ops(run), flush),
        kernel_row("gf_bitmatmul_stream (K4, 8 x 512 KiB -> 3)",
                   "csrc/gf_bitmatmul_stream.cu",
                   "ceph_tpu/ops/bitsliced.py:245", "gf_bitmatmul_stream",
                   "w32_sweep",
                   lambda: bs.gf_bitmatmul_stream(enc, data),
                   lambda: bs.gf_bitmatmul_stream_plain(enc, data),
                   [(M, run)], gf_bytes(M, run), gf_ops(M, run), flush),
    ]
    del flush
    return rows


def pin_point(cache_file, dev, point: dict) -> None:
    """Pin the fused write path's operating point the way an operator
    does: a cache row for this card's key, and CEPH_TPU_AUTOTUNE_CACHE
    pointing at the file."""
    from ceph_tpu_torch.ops import autotune
    key = autotune._device_key(dev, K, M)
    cache_file.write_text(json.dumps({"version": 2, "entries": {
        key: {**point, "gbps": 0.0, "when": "pinned"}}}))
    os.environ["CEPH_TPU_AUTOTUNE_CACHE"] = str(cache_file)


def make_backend(dev, stages):
    """A torch codec (its point read from the autotune cache) and an
    ECBackend over MemStore whose shards can be made to fail reads."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import pg_t
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
    be = ECBackend(codec, sinfo, shards, dispatch_depth=2, perf=stages)
    return codec, sinfo, store, shards, be


class Writer:
    """Submits writes to one backend and keeps the expected bytes."""

    def __init__(self, be, rng):
        self.be = be
        self.rng = rng
        self.expect: dict[str, np.ndarray] = {}
        self.version = 0
        self.acks = []

    @staticmethod
    def oid(name):
        from ceph_tpu_torch.osd.types import hobject_t
        return hobject_t(pool=1, name=name)

    def payload(self, n):
        return np.frombuffer(self.rng.bytes(n), dtype=np.uint8)

    def submit(self, name, off, data):
        from ceph_tpu_torch.osd.ec_transaction import PGTransaction
        from ceph_tpu_torch.osd.types import eversion_t
        txn = PGTransaction()
        txn.write(self.oid(name), off, data)
        self.version += 1
        self.be.submit_transaction(txn, eversion_t(1, self.version),
                                   lambda v=self.version: self.acks.append(v))
        cur = self.expect.get(name)
        if cur is None and off == 0:
            self.expect[name] = data     # payloads are never mutated
            return
        cur = np.zeros(0, dtype=np.uint8) if cur is None else cur
        new = np.zeros(max(cur.size, off + data.size), dtype=np.uint8)
        new[:cur.size] = cur
        new[off:off + data.size] = data
        self.expect[name] = new

    def check_readback(self, names=None):
        for name in names or self.expect:
            got = self.be.read(self.oid(name))
            if got.shape != self.expect[name].shape or \
                    not np.array_equal(got, self.expect[name]):
                raise AssertionError(f"read back of {name} differs")


def check_parity(codec, sinfo, store, shards, w, name) -> None:
    """Every shard of one object against the host GF(2^8) encode."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.osd import ec_transaction as ect
    from ceph_tpu_torch.osd import ec_util
    host = ec_util.encode(sinfo, codec, w.expect[name])
    ref = gf.gf_matvec(codec.matrix[K:], host[:K])
    for s in range(K + M):
        stored = store.read(shards.cids[s], ect.shard_oid(w.oid(name), s))
        want = host[s] if s < K else ref[s - K]
        if not np.array_equal(stored, want):
            raise AssertionError(f"shard {s} of {name} differs from the host "
                                 "reference encode")


def check_crcs(store, shards, w) -> int:
    """Every valid HashInfo crc against the host crc32c of the stored
    shard bytes; returns how many objects carried one."""
    from ceph_tpu_torch.common import crc32c
    from ceph_tpu_torch.osd import ec_transaction as ect
    n_crc = 0
    for name in w.expect:
        hinfo = shards.get_hinfo(0, w.oid(name))
        if not hinfo.crc_valid:
            continue
        rows = np.stack([store.read(shards.cids[s],
                                    ect.shard_oid(w.oid(name), s))
                         for s in range(K + M)])
        if crc32c.crc32c_rows(rows, [0xFFFFFFFF] * (K + M)) != \
                list(hinfo.cumulative_shard_hashes):
            raise AssertionError(f"HashInfo crc of {name} differs from the "
                                 "host crc32c of its shards")
        n_crc += 1
    return n_crc


def degraded_reads(be, shards, w, names) -> tuple[int, float]:
    """Read `names` with shards 0 and 1 failing (K1 decode), then every
    other object healthy; returns (bytes read degraded, seconds)."""
    shards.down = {0, 1}
    t0 = time.perf_counter()
    nread = 0
    for name in names:
        got = be.read(w.oid(name))
        nread += got.size
        if not np.array_equal(got, w.expect[name]):
            raise AssertionError(f"degraded read of {name} differs")
    t_deg = time.perf_counter() - t0
    w.check_readback([n for n in w.expect if n not in names])
    torch.cuda.synchronize()
    shards.down = set()
    return nread, t_deg


def check_drained(be) -> None:
    if len(be.extent_cache) or be._projected or be._inflight:
        raise AssertionError("pipeline state did not drain")


def phase_main_path(dev, rng, combine: str, n_big: int):
    """The port's write and degraded-read path, k=8 m=3, at the pinned
    `combine`; returns (per-phase launch counts, throughput dict)."""
    from ceph_tpu_torch.ops import bitsliced as bs

    stages = StageTimes()
    codec, sinfo, store, shards, be = make_backend(dev, stages)
    point = codec.fused_point()
    if point["combine"] != combine:
        raise AssertionError(f"pinned point not read: {point}")
    # every fused result's (tail width, body, run width)
    fused = []
    real_finalize = codec.encode_extents_with_crc_finalize

    def finalize(handle):
        res = real_finalize(handle)
        fused.extend((r[2].shape[1], r[3], r[0].shape[1]) for r in res)
        return res
    codec.encode_extents_with_crc_finalize = finalize
    w = Writer(be, rng)
    big = {f"big{i}": w.payload(BIG) for i in range(n_big)}
    small = {f"small{i}": w.payload(SMALL) for i in range(N_SMALL)}
    mixed = {f"mixbig{i}": w.payload(BIG) for i in range(2)}
    mixed.update({f"mixsmall{i}": w.payload(SMALL) for i in range(4)})
    torch.cuda.synchronize()

    counts = {}
    # -- write path ---------------------------------------------------
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    with be.pipeline():
        for name, p in big.items():
            w.submit(name, 0, p)
    t_big = time.perf_counter() - t0
    write_stages = dict(stages.t)
    paths = {"big": be.fused_path}

    # device busy share over a steady window of 8 more 4 MiB writes; the
    # wall clock runs inside the profiled region, so the profiler's own
    # start-up is not counted
    window_data = {f"prof{i}": w.payload(BIG) for i in range(8)}
    win = {}

    def window():
        t0 = time.perf_counter()
        with be.pipeline():
            for name, p in window_data.items():
                w.submit(name, 0, p)
        torch.cuda.synchronize()
        win["s"] = time.perf_counter() - t0
    evs = device_events(window)
    t_win = win["s"]
    busy_ms = sum(us for _, us in evs) / 1e3
    kernel_ms = sum(us for name, us in evs
                    if "Memcpy" not in name and "Memset" not in name) / 1e3
    with be.pipeline():
        for name, p in small.items():
            w.submit(name, 0, p)
    paths["small"] = be.fused_path
    launches_before = be.batched_launches
    with be.batch():
        for name, p in mixed.items():
            w.submit(name, 0, p)
    paths["mixed"] = be.fused_path
    if be.batched_launches != launches_before + 1:
        raise AssertionError("the mixed batch did not drain as one launch")
    with be.pipeline():
        for i in range(N_RMW):
            w.submit(f"big{i}", (1 << 20) + 1000 + 4096 * i,
                     w.payload(RMW_LEN))
    torch.cuda.synchronize()
    counts[f"{combine}_write"] = bs.launch_counts()
    if w.acks != list(range(1, w.version + 1)):
        raise AssertionError("acks out of order or missing")
    hier = "hier_acc" if combine == "kernel" else "hier_lsub"
    if paths != {"big": hier, "small": "w32_flat",
                 "mixed": f"{hier}+w32_flat"}:
        raise AssertionError(f"unexpected kernel paths {paths}")
    n_fused = n_big + 8 + N_SMALL + len(mixed)
    if len(fused) != n_fused or \
            any(tail or body != width for tail, body, width in fused):
        raise AssertionError(f"fused results with a tail, or missing: "
                             f"{len(fused)} of {n_fused}")

    w.check_readback()
    check_parity(codec, sinfo, store, shards, w, f"big{n_big - 1}")
    n_crc = check_crcs(store, shards, w)
    if n_crc < n_big - N_RMW + 8 + N_SMALL + len(mixed):
        raise AssertionError(f"only {n_crc} objects carry a valid crc")

    # -- degraded read path -------------------------------------------
    bs.reset_launch_counts()
    nread, t_deg = degraded_reads(be, shards, w, big)
    counts[f"{combine}_read"] = bs.launch_counts()
    check_drained(be)
    perf = {"point": point,
            "write_4MiB_objects_GBps": n_big * BIG / t_big / 1e9,
            "write_4MiB_objects_s": t_big, "write_4MiB_objects": n_big,
            "write_stage_s": write_stages,
            "window_wall_ms": t_win * 1e3,
            "window_device_busy_ms": busy_ms,
            "window_device_kernel_ms": kernel_ms,
            "window_device_busy_share": busy_ms / (t_win * 1e3),
            "degraded_read_4MiB_objects_GBps": nread / t_deg / 1e9,
            "degraded_read_4MiB_objects_s": t_deg,
            "objects": len(w.expect), "crc_checked_objects": n_crc,
            "fused_results_tail_free": len(fused), "paths": paths}
    return counts, perf


def phase_bytes_path(dev, rng) -> tuple[dict, dict]:
    """Phase D: the write path on the byte branch (codec._use_w32 =
    False): every drain one launch of K2's byte entry at 2 KiB tiles,
    path "bytes", the operating point never consulted.  16 x 4 MiB and
    16 x 64 KiB in pipeline windows, one mixed batch(), then readback,
    degraded reads with shards 0 and 1 down, parity and HashInfo
    checks.  Returns (launch counts of the writes, throughput dict)."""
    from ceph_tpu_torch.ops import bitsliced as bs

    stages = StageTimes()
    codec, sinfo, store, shards, be = make_backend(dev, stages)
    codec._use_w32 = False
    w = Writer(be, rng)
    big = {f"bbig{i}": w.payload(BIG) for i in range(N_BIG_BYTES)}
    small = {f"bsmall{i}": w.payload(SMALL) for i in range(N_SMALL)}
    mixed = {f"bmixbig{i}": w.payload(BIG) for i in range(2)}
    mixed.update({f"bmixsmall{i}": w.payload(SMALL) for i in range(4)})
    paths = set()
    real_submit = codec.encode_extents_with_crc_submit

    def submit(runs):
        handle = real_submit(runs)
        paths.add(handle["path"])
        return handle
    codec.encode_extents_with_crc_submit = submit
    torch.cuda.synchronize()
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    with be.pipeline():
        for name, p in big.items():
            w.submit(name, 0, p)
    t_big = time.perf_counter() - t0
    write_stages = dict(stages.t)
    with be.pipeline():
        for name, p in small.items():
            w.submit(name, 0, p)
    with be.batch():
        for name, p in mixed.items():
            w.submit(name, 0, p)
    torch.cuda.synchronize()
    counts = bs.launch_counts()
    if paths != {"bytes"} or codec._fused_point is not None:
        raise AssertionError(f"byte branch took {paths}, point "
                             f"{codec._fused_point}")
    others = {n: c for n, c in counts.items()
              if n in ("fused_hier_call", "gf_encode_with_crc_w32",
                       "fused_hier_acc_call") and c}
    if counts["gf_encode_with_crc"] <= 0 or others:
        raise AssertionError(f"byte branch launches {counts}")
    drains = stages.n.get("ec_fused_fallback_drains", 0)
    if drains <= 0 or stages.n.get("ec_fused_kernel_drains", 0):
        raise AssertionError(f"byte drains not counted as fallback: "
                             f"{stages.n}")
    w.check_readback()
    check_parity(codec, sinfo, store, shards, w, f"bbig{N_BIG_BYTES - 1}")
    n_crc = check_crcs(store, shards, w)
    if n_crc != len(w.expect):
        raise AssertionError(f"only {n_crc} of {len(w.expect)} objects "
                             "carry a valid crc")
    nread, t_deg = degraded_reads(be, shards, w, big)
    check_drained(be)
    return counts, {
        "write_4MiB_objects_GBps": len(big) * BIG / t_big / 1e9,
        "write_4MiB_objects_s": t_big, "write_4MiB_objects": len(big),
        "write_stage_s": write_stages,
        "degraded_read_4MiB_objects_GBps": nread / t_deg / 1e9,
        "objects": len(w.expect), "crc_checked_objects": n_crc,
        "fallback_drains": drains, "paths": sorted(paths)}


def phase_w32_sweep() -> tuple[dict, list[dict]]:
    """Phase E: tools/w32_sweep at full size (4 MiB a chunk), K1 and
    K4 over tiles 64 KiB - 4 MiB; every row exact, none with an error.
    Returns (launch counts of the sweep, its rows)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.tools import w32_sweep

    torch.cuda.synchronize()
    bs.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = w32_sweep.sweep(w32_sweep.parse_args([]))
    torch.cuda.synchronize()
    counts = bs.launch_counts()
    if len(rows) != 2 * len(w32_sweep.TILES) or any(
            "error" in r or not r["exact"] for r in rows):
        raise AssertionError(f"w32_sweep rows failed: {rows}")
    for r in rows:
        print(f"# w32_sweep stream={r['stream']!s:5} tile={r['tile']:8d} "
              f"exact={r['exact']} GB/s={r.get('gbps')}", flush=True)
    return counts, rows


def k4_groups_table(dev, rng) -> list[dict]:
    """K1 and K4 at their default grids over widths of 16 KiB - 4 MiB a
    row (8 -> 3, the write path's Cauchy code) and K4's group counts
    G = 1, 2, 4, 8: where the time of the GF(2^8) apply goes.  Each
    entry checked against K1's plain version, then timed as the kernel
    rows are (graph replays)."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    enc = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(K, M)[K:]),
                           dev)
    table = []
    for width in (16 << 10, 128 << 10, 512 << 10, 4 << 20):
        data = torch.from_numpy(
            rng.integers(0, 256, (K, width), dtype=np.uint8)).to(dev)
        want = bs.gf_bitmatmul_plain(enc, data)
        variants = [("K1", lambda: bs.gf_bitmatmul(enc, data))] + [
            (f"K4 G={g}", lambda g=g: bs.gf_bitmatmul_stream(enc, data,
                                                            groups=g))
            for g in (1, 2, 4, 8)]
        for name, fn in variants:
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} at {width} B differs")
            us = graph_event_ms(fn) * 1e3
            table.append({"kernel": name, "row_bytes": width, "us": us,
                          "GBps": K * width / us / 1e3})
            print(f"# k4_groups {name:7s} row={width:8d} B  {us:9.3f} us  "
                  f"{K * width / us / 1e3:8.1f} GB/s", flush=True)
    return table


def phase_ab() -> dict:
    """Phase F: the CPU plugins with the native library, and
    ec_benchmark --ab (isa against torch, per call and batch 32), then
    -p isa and -p jerasure with the reference's canonical invocation."""
    from ceph_tpu_torch.common import native
    from ceph_tpu_torch.tools import ec_benchmark

    if not native.available():
        raise AssertionError("the native CPU library did not build")

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ec_benchmark.main(argv)
        if rc != 0:
            raise AssertionError(f"ec_benchmark {argv} exited {rc}")
        print(f"# ec_benchmark {' '.join(argv)}", flush=True)
        return buf.getvalue().strip().splitlines()

    ab = [json.loads(line) for line in run(
        ["--ab", "-P", f"k={K}", "-P", f"m={M}", "-S", "1048576",
         "--batch", "32", "--min-time", "1"])]
    sides = {(r["side"], r["mode"]) for r in ab if "side" in r}
    ratios = {r["ratio_mode"]: r["torch_over_cpu"] for r in ab
              if "ratio_mode" in r}
    if sides != {(s, m) for s in ("isa", "torch")
                 for m in ("per_call", "batched")} or \
            set(ratios) != {"per_call", "batched"}:
        raise AssertionError(f"--ab rows incomplete: {ab}")
    for r in ab:
        print(f"# {json.dumps(r)}", flush=True)
    cpu = {}
    for plugin in ("isa", "jerasure"):
        (line,) = run(["-p", plugin, "-P", f"k={K}", "-P", f"m={M}",
                       "-S", "1048576", "-i", "1000"])
        sec, kib = line.split("\t")
        cpu[plugin] = {"line": line,
                       "GBps": int(kib) * 1024 / float(sec) / 1e9}
        print(f"{line}\t# {cpu[plugin]['GBps']:.3f} GB/s", flush=True)
    return {"ab": ab, "cpu_plugins": cpu}


def phase_sweep(dev, cache_file) -> dict:
    """Phase A: the autotune sweep on the card with a fresh cache, then a
    second plugin init that must read the cached row with no
    measurement."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import autotune

    os.environ["CEPH_TPU_AUTOTUNE_CACHE"] = str(cache_file)
    reg = ErasureCodePluginRegistry.instance()
    prof = {"k": str(K), "m": str(M), "device": str(dev)}
    codec = reg.factory("torch", prof)
    measured = []
    real = autotune._measure

    def counting(tables, k, m, cand):
        measured.append(cand)
        return real(tables, k, m, cand)
    autotune._measure = counting
    try:
        report = []
        t0 = time.perf_counter()
        best = autotune.fused_operating_point(
            K, M, tables=codec._enc_tables, mat=codec.matrix[K:],
            report=report)
        t_sweep = time.perf_counter() - t0
        n_sweep = len(measured)
        again = reg.factory("torch", prof).fused_point()
        n_again = len(measured) - n_sweep
    finally:
        autotune._measure = real
    table = [{"wb": c["wb"], "combine": c["combine"], "valid": r is not None,
              "GBps": None if r is None else r / 1e9} for c, r in report]
    for row in table:
        print(f"# sweep wb={row['wb']:5d} combine={row['combine']:6s} "
              f"valid={row['valid']} GB/s={row['GBps']}", flush=True)
    if len(table) != 6 or not all(row["valid"] for row in table):
        raise AssertionError(f"sweep table incomplete or invalid: {table}")
    key = autotune._device_key(dev, K, M)
    entry = autotune._load_cache()["entries"].get(key)
    maj, mnr = torch.cuda.get_device_capability(dev)
    for part in (torch.cuda.get_device_name(dev), f"/sm{maj}{mnr}/",
                 f"/torch{torch.__version__}/", f"/{autotune.KERNEL_GEN}/"):
        if part not in key:
            raise AssertionError(f"cache key {key!r} lacks {part!r}")
    if entry is None or {kk: entry[kk] for kk in best} != best:
        raise AssertionError(f"cache row {entry} is not the winner {best}")
    if again != best or n_again:
        raise AssertionError(f"second init measured {n_again} times or "
                             f"picked {again} instead of {best}")
    return {"best": best, "table": table, "sweep_s": t_sweep,
            "measurements": n_sweep, "cache_key": key,
            "second_init_measurements": n_again}


def write_round(dev, rng, n: int, tag: str) -> dict:
    """n x 4 MiB writes in one pipeline window on a fresh backend whose
    codec reads its point from the current autotune cache; every object
    read back."""
    stages = StageTimes()
    codec, _, _, _, be = make_backend(dev, stages)
    point = codec.fused_point()
    w = Writer(be, rng)
    data = {f"{tag}{i}": w.payload(BIG) for i in range(n)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with be.pipeline():
        for name, p in data.items():
            w.submit(name, 0, p)
    t = time.perf_counter() - t0
    w.check_readback()
    return {"point": point, "path": be.fused_path,
            "write_4MiB_objects_GBps": n * BIG / t / 1e9,
            "write_4MiB_objects_s": t, "write_4MiB_objects": n,
            "write_stage_s": stages.t}


def phase_write_ab(dev, rng, tmp, best: dict) -> dict:
    """The write path at the point the sweep picked (read from the
    sweep's cache), then an interleaved A/B of the two combines, each
    pinned through its own cache file, in the order xla, kernel,
    kernel, xla, xla, kernel — so drift of the shared host cancels."""
    from ceph_tpu_torch.ops import autotune
    os.environ["CEPH_TPU_AUTOTUNE_CACHE"] = str(tmp / "sweep.json")
    picked = write_round(dev, rng, N_BIG_PICK, "pick")
    if picked["point"] != best:
        raise AssertionError(f"{picked['point']} is not the swept point "
                             f"{best}")
    rounds = {"xla": [], "kernel": []}
    for combine in ("xla", "kernel", "kernel", "xla", "xla", "kernel"):
        pin_point(tmp / f"ab_{combine}.json", dev,
                  dict(autotune.default_point(), combine=combine))
        res = write_round(dev, rng, N_BIG_PICK, "ab")
        want = "hier_acc" if combine == "kernel" else "hier_lsub"
        if res["path"] != want:
            raise AssertionError(f"A/B round at {combine} took {res['path']}")
        rounds[combine].append(res["write_4MiB_objects_GBps"])
    return {"at_swept_point": picked, "ab_GBps": rounds,
            "ab_median_GBps": {c: statistics.median(v)
                               for c, v in rounds.items()}}


def phase_benchmark():
    """Phase C: the ec_benchmark CLI on the card; returns (launch counts
    of the two encode invocations, of the two decode invocations, one
    dict per invocation)."""
    from ceph_tpu_torch.ec.plugins import ec_torch
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.tools import ec_benchmark

    base = ["-p", "torch", "-P", f"k={K}", "-P", f"m={M}",
            "-S", "1048576", "-i", "1000"]
    invocations = [base, base + ["--batch", "32"],
                   base + ["-w", "decode", "-e", "1"],
                   base + ["-w", "decode", "-e", "2", "-E", "exhaustive"]]
    erasure_sets = set()
    real = ec_torch.ErasureCodeTorch.decode_chunks

    def spy(self, dense, erasures):
        erasure_sets.add(tuple(sorted(erasures)))
        return real(self, dense, erasures)
    out = []
    counts = []
    ec_torch.ErasureCodeTorch.decode_chunks = spy
    try:
        for i, argv in enumerate(invocations):
            if i in (0, 2):         # counts of the encode, then decode pair
                torch.cuda.synchronize()
                bs.reset_launch_counts()
            erasure_sets.clear()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = ec_benchmark.main(argv)
            if rc != 0:
                raise AssertionError(f"ec_benchmark {argv} exited {rc}")
            line = buf.getvalue().strip().splitlines()[-1]
            sec, kib = line.split("\t")
            gbps = int(kib) * 1024 / float(sec) / 1e9
            print(f"# ec_benchmark {' '.join(argv)}", flush=True)
            print(f"{line}\t# {gbps:.3f} GB/s", flush=True)
            out.append({"args": " ".join(argv), "line": line,
                        "seconds": float(sec), "KiB": int(kib),
                        "GBps": gbps,
                        "erasure_sets_verified": len(erasure_sets)})
            if i in (1, 3):
                torch.cuda.synchronize()
                counts.append(bs.launch_counts())
    finally:
        ec_torch.ErasureCodeTorch.decode_chunks = real
    if out[3]["erasure_sets_verified"] != 55 or \
            out[2]["erasure_sets_verified"] != 1:
        raise AssertionError(f"decode verified {out[3]} / {out[2]}")
    if counts[1]["gf_bitmatmul"] <= 0:
        raise AssertionError("the decode workload launched no K1")
    return counts[0], counts[1], out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from pathlib import Path

    from ceph_tpu_torch import resolve_device
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry, gf
    from ceph_tpu_torch.ops import _build, autotune
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

    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": str(K), "m": str(M), "device": str(dev)})
    rows = phase_kernels(dev, bs, gf, rng, codec)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        pin_point(tmp / "pinned_xla.json", dev,
                  dict(autotune.default_point(), combine="xla"))
        counts, perf_xla = phase_main_path(dev, rng, "xla", N_BIG_XLA)
        sweep = phase_sweep(dev, tmp / "sweep.json")
        pin_point(tmp / "pinned_kernel.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        counts_k, perf_kernel = phase_main_path(dev, rng, "kernel",
                                                N_BIG_ACC)
        counts.update(counts_k)
        perf_pick = phase_write_ab(dev, rng, tmp, sweep["best"])
        counts["bytes_write"], perf_bytes = phase_bytes_path(dev, rng)
        counts["bench_encode"], counts["bench_decode"], bench = \
            phase_benchmark()
        counts["w32_sweep"], w32_rows = phase_w32_sweep()
        groups = k4_groups_table(dev, rng)
        ab = phase_ab()
    finally:
        os.environ.pop("CEPH_TPU_AUTOTUNE_CACHE", None)
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        phase = row.pop("phase")
        row["launches"] = counts[phase][row.pop("counter")]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its "
                                 f"phase ({phase})")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"sweep": sweep}), flush=True)
    print(json.dumps({"main_path_xla": perf_xla}), flush=True)
    print(json.dumps({"main_path_kernel": perf_kernel,
                      "write_ab": perf_pick}), flush=True)
    print(json.dumps({"main_path_bytes": perf_bytes}), flush=True)
    print(json.dumps({"ec_benchmark": bench, "launch_counts": counts}),
          flush=True)
    print(json.dumps({"w32_sweep": w32_rows, "k4_groups": groups}),
          flush=True)
    print(json.dumps({"ec_benchmark_ab": ab}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

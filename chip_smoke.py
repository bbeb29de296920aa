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
   computes these functions, so library_ms is null.  Fifteen rows:
   K1 (encode, decode, the device entry), K2's three entries (hier, w32
   flat, and the byte entry of Pallas #6 at 8+3 x 512 KiB), K2's narrow
   branch (the hier entry at 16 KiB sub-blocks, which no path here
   selects: its launches are counted over every phase and may be 0), K3
   (one run, two runs), K5 (the deep-scrub crc of the JAX package's
   jitted `_rows_l`: a 64 MiB chunk of 132 x 512 KiB rows, a chunk of
   mixed rows, and an edge chunk whose rows cross the warps' block
   ranges, with rows of one block and empty rows) and K4 (Pallas #7's
   counterpart: 8 x 512 KiB -> 3 at one pass, and the CLAY repair
   matrices of phase G, 64 x 176 over 32 objects' 8 KiB sub-chunks and
   81 x 270 over 32 x 6473 B at two passes).  Then the K3 table: K3 on one 512 KiB run at B = 1,
   2 and 4 KiB, with its L zero-fill and without, and K2's hier entry
   at the same block as the run's control; the zero-fill alone; the two
   K3 rows beside their times before K3's redesign.  Then the K2 table:
   K2's hier entry at those blocks with its grid, and K2's three rows,
   beside their times before K2's redesign, K3 as the control.
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
   per block, every configuration exact before it is timed.  Then K1 at
   4 and 16 bytes of each row a thread and at k1_launch's pick (printed
   for each width), and K4 forced to 1, 2, 4 and 8 passes of the 8
   source rows, at their default grids over rows of 16 KiB - 4 MiB,
   checked and timed as the kernel rows are.
8. CLAY repair (phase G): for k=8 m=4 d=11 (BASELINE.json) and k=8
   m=3 d=10, 32 objects of 4 MiB encoded on the host; for every lost
   chunk (12 and 11) a ClayRepairPlan and one apply_batch over the 32
   objects' helper repair planes (one K4 launch), every rebuilt chunk
   equal to the lost chunk, the batch to K4's plain version on the card
   and one object a chunk to codec.repair on the host; launches, wall
   time and GB/s of rebuilt bytes.  Then K4 at the batch shape at 1x,
   2x and 4x its fewest passes.
9. Recovery storm (phase H): an OSD-loss storm through one per-host
   ECLaunchQueue.  torch k=8 m=3 (its point pinned to K3), four PGs
   whose backends share the queue, 64 objects a PG of 4 MiB (RBD) and
   then of 64 KiB (small S3 objects), written round-robin through the
   queue (K3, K2's flat entry); then one shard (3) and then shards
   {0, 9} of every object lost and recovered in steps of three objects
   a PG, every PG's recover_shards_submit before any
   recover_shards_finalize (the halves of recover_shards_batch): K1
   decodes through the queue, at most 64 KiB of columns a coalesced
   launch.  Then CLAY k=8 m=4 d=11, two PGs x 16 objects of 4 MiB, chunk
   2 lost and repaired from the repair planes of 11 helpers through the
   queue (K4).  Every rebuilt shard must equal the lost bytes and its
   crc32c the stored HashInfo's; it is pushed back with its recovery
   xattrs.  Launch counters are zeroed before each write and recovery
   and read after; each recovery must have launched its kernel, and the
   small-object storm must show a decode launch that coalesced PGs.
   Rebuilt GB/s, wall time, the queue's status (launches, submissions a
   launch, cross-PG launches) and the flight recorder's launches by
   kind are printed with the card's name and power limit.
10. Deep scrub (phase I): the reference's deep-scrub bench setting,
   torch k=8 m=3 at the pinned K3 point, objects of 8 MiB with a 16 KiB
   stripe unit (1 MiB shard rows), 64 MiB scrub chunks.  Four PGs of 16
   objects (704 MiB of shards) and a fifth PG, with a 1 KiB stripe
   unit, of 8 objects of 8 MiB + 777 B, whose shard rows end in a 1 KiB
   tail.  A deep scrub of the clean PGs must find nothing, with one K5
   launch a chunk (14), the whole blocks counted as device bytes and
   the tails as host bytes.  Then bytes flip in 8 shards of different
   objects (data and parity shards, one byte in a tail), and a scrub
   with repair must find each as crc_mismatch on its shard and rebuild
   it (K1) to its original bytes.  Then a scrub of the same PGs on the
   host crc32c (the native library), and the device path again.  Walls
   and verified GB/s of both paths, the K5 launches, the byte split and
   the repair's K1 launches are printed.
11. A/B (phase F): the native CPU library must have built; then
   ec_benchmark --ab (isa against torch, 1 MiB objects, per call and
   --batch 32, 1 s a side and mode) and -p isa / -p jerasure with the
   canonical invocation.

Output: the card's name and power limit, the sweep tables, the kernels,
K3 table and K2 table JSON lines (each kernel row with its launches on
its own phase and in the recovery storm), the main paths', the
benchmark's, the w32 sweep's, the CLAY repair's, the recovery storm's,
the deep scrub's and the A/B's lines, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
(the script drives one card).  Any failure raises and exits non-zero.
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
# CLAY profiles of phase G: BASELINE.json's k=8 m=4 d=11 and the k=8 m=3
# d=10 geometry of the ISA-L default profile's (k, m)
CLAY_PROFILES = {"k8m4d11": (8, 4, 11), "k8m3d10": (8, 3, 10)}
N_CLAY_OBJECTS = 32
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
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:523",
                   "fused_hier_call", "xla_write",
                   lambda: bs.fused_hier_call(enc, data, bs.FUSED_WB),
                   lambda: bs.fused_hier_call_plain(enc, data, bs.FUSED_WB),
                   [(M, run), (K + M, run // block)],
                   gf_bytes(M, run) + (K + M) * (run // block) * 4,
                   gf_ops(M, run) + crc_ops(run), flush),
        kernel_row("gf_encode_with_crc_w32 (K2, 2 KiB tiles)",
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:437",
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
                   "csrc/gf_encode_crc_acc.cu",
                   "ceph_tpu/ops/bitsliced.py:385",
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
    # K2's narrow branch (one shared crc table, the operators from their
    # columns), which 8+3 takes at 16 KiB sub-blocks: no path of this
    # script selects it, so its launches (bs._encode_crc_launch's
    # narrow count over every phase) are expected to be 0
    narrow_wb = 4096
    if bs.k2_lane_tables(M, K, 4 * narrow_wb):
        raise AssertionError("8+3 at 16 KiB no longer takes K2's narrow "
                             "branch")
    nb = 4 * narrow_wb
    rows.append(kernel_row(
        "fused_hier_call (K2 narrow branch, 16 KiB sub-blocks)",
        "csrc/gf_encode_crc_acc.cu", "ceph_tpu/ops/bitsliced.py:523",
        None, None,
        lambda: bs.fused_hier_call(enc, data, narrow_wb),
        lambda: bs.fused_hier_call_plain(enc, data, narrow_wb),
        [(M, run), (K + M, run // nb)],
        gf_bytes(M, run) + (K + M) * (run // nb) * 4,
        gf_ops(M, run) + crc_ops(run), flush))
    # K5 at a 64 MiB scrub chunk of 4 MiB objects (132 rows of 512 KiB),
    # at a chunk of mixed rows: 66 of 1 MiB (phase I's), 11 of 600 KiB,
    # 11 of one block and 3 empty, and at an edge chunk whose rows cross
    # the warps' block ranges, with rows of one block and empty rows
    # (tools/k3_phases.K5_SHAPES)
    from ceph_tpu_torch.tools.k3_phases import K5_SHAPES
    for label, counts in (
            ("132 x 512 KiB", K5_SHAPES["chunk"]),
            ("mixed: 66 x 1 MiB, 11 x 600 KiB, 11 x 2 KiB, 3 empty",
             K5_SHAPES["mixed"]),
            ("edge: 64 x (1, 0, 7, 1, 0, 0, 13, 1 blocks) + 4099 blocks",
             K5_SHAPES["edge"])):
        n = sum(counts) * 2048
        body = torch.from_numpy(np.frombuffer(rng.bytes(n), dtype=np.uint8)
                                .copy()).to(dev)
        ends = torch.tensor(np.cumsum(counts), dtype=torch.int64,
                            device=dev)
        rows.append(kernel_row(
            f"crc32c_rows (K5, {label})", "csrc/gf_encode_crc_acc.cu",
            "ceph_tpu/ops/crc32c_linear.py:189", "crc32c_rows_l",
            "deep_scrub",
            lambda b=body, e=ends: bs.crc32c_rows_l(b, e),
            lambda b=body, e=ends: bs.crc32c_rows_l_plain(b, e),
            [(len(counts),)], n + 16 * len(counts), n, flush))
    for name, (ck, cm, cd) in CLAY_PROFILES.items():
        codec_c = clay_codec(ck, cm, cd)
        mat = codec_c.repair_matrix(0)
        r, j = mat.shape
        n = N_CLAY_OBJECTS * clay_sub_size(codec_c)
        tab = bs.tables_tensor(gf.product_tables(mat), dev)
        rows_c = torch.from_numpy(
            rng.integers(0, 256, (j, n), dtype=np.uint8)).to(dev)
        passes = bs.k4_plan(r, j, n, torch.cuda.get_device_properties(
            dev).multi_processor_count).passes
        rows.append(kernel_row(
            f"gf_bitmatmul_stream (K4, CLAY {name}: {r} x {j} over "
            f"{N_CLAY_OBJECTS} x {n // N_CLAY_OBJECTS} B, {passes} "
            f"pass{'es' if passes > 1 else ''})",
            "csrc/gf_bitmatmul_stream.cu", "ceph_tpu/ops/bitsliced.py:245",
            "gf_bitmatmul_stream", "clay_repair",
            lambda tab=tab, x=rows_c: bs.gf_bitmatmul_stream(tab, x),
            lambda tab=tab, x=rows_c: bs.gf_bitmatmul_stream_plain(tab, x),
            [(r, n)], j * n + r * n + r * j * 256, 2 * r * j * n, flush))
    del flush
    return rows


def clay_codec(k: int, m: int, d: int):
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    return ErasureCodePluginRegistry.instance().factory(
        "clay", {"k": str(k), "m": str(m), "d": str(d)})


def clay_sub_size(codec) -> int:
    """Bytes a sub-chunk of a 4 MiB object: 8192 at k=8 m=4 d=11, 6473
    at k=8 m=3 d=10 (its chunk aligned to 81 sub-chunks)."""
    return codec.get_chunk_size(BIG) // codec.get_sub_chunk_count()


def phase_clay_repair(dev, rng) -> tuple[dict, dict]:
    """Phase G: CLAY single-chunk repair on the card.  For each CLAY
    profile of BASELINE.json's configs and k=8 m=3 d=10, 32 objects of
    4 MiB are encoded on the host; for every lost chunk a ClayRepairPlan
    is built and one apply_batch (one K4 launch) rebuilds the chunk of
    all 32 objects from their helpers' repair planes.  Every rebuilt
    chunk must equal the object's lost chunk, the batch K4's plain
    version on the card, and one object a lost chunk codec.repair on the
    host.  Returns (launch counts of the repairs, the report).  Then K4
    at each profile's batch shape at more passes than it needs (the
    multi-pass path at these shapes), checked and timed as the kernel
    rows are."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.parallel import ClayRepairPlan

    report = {}
    counts = {}
    for name, (ck, cm, cd) in CLAY_PROFILES.items():
        codec = clay_codec(ck, cm, cd)
        n_chunks = ck + cm
        sub = codec.get_sub_chunk_count()
        s = clay_sub_size(codec)
        t0 = time.perf_counter()
        encs = [codec.encode(set(range(n_chunks)), rng.bytes(BIG))
                for _ in range(N_CLAY_OBJECTS)]
        t_encode = time.perf_counter() - t0
        if len(encs[0][0]) != sub * s:
            raise AssertionError(f"{name}: chunk of {len(encs[0][0])} B")
        plans, batches = [], []
        for lost in range(n_chunks):
            plan = ClayRepairPlan.build(codec, lost, device=dev)
            planes = codec.repair_planes(lost)
            batches.append([codec.repair_rows(lost, {
                ch: np.asarray(e[ch]).reshape(sub, s)[planes]
                for ch in plan.helper_ids}) for e in encs])
            plan.tables_tensor()
            plans.append(plan)
        torch.cuda.synchronize()
        bs.reset_launch_counts()
        per_chunk_s = []
        outs = []
        for plan, batch in zip(plans, batches):
            t0 = time.perf_counter()
            outs.append(plan.apply_batch(batch))
            per_chunk_s.append(time.perf_counter() - t0)
        counts[name] = bs.launch_counts()
        if counts[name]["gf_bitmatmul_stream"] != n_chunks:
            raise AssertionError(f"{name}: {counts[name]} launches for "
                                 f"{n_chunks} batches")
        for lost, (plan, batch, out) in enumerate(zip(plans, batches, outs)):
            for i, e in enumerate(encs):
                if not np.array_equal(out[i].reshape(-1), e[lost]):
                    raise AssertionError(f"{name}: chunk {lost} of object "
                                         f"{i} rebuilt wrong")
            i = lost % N_CLAY_OBJECTS
            planes = codec.repair_planes(lost)
            host = codec.repair(lost, {
                ch: np.asarray(encs[i][ch]).reshape(sub, s)[planes]
                for ch in plan.helper_ids}, s)
            if not np.array_equal(out[i].reshape(-1), host):
                raise AssertionError(f"{name}: chunk {lost} of object {i} "
                                     "differs from codec.repair")
            big = torch.from_numpy(np.concatenate(batch, axis=1)).to(dev)
            plain = bs.gf_bitmatmul_stream_plain(plan.tables_tensor(), big)
            if not np.array_equal(np.concatenate(out, axis=1),
                                  plain.cpu().numpy()):
                raise AssertionError(f"{name}: chunk {lost} batch differs "
                                     "from K4's plain version")
        rebuilt = n_chunks * N_CLAY_OBJECTS * sub * s
        wall = sum(per_chunk_s)
        report[name] = {
            "profile": {"k": ck, "m": cm, "d": cd},
            "matrix": [plans[0].out_rows, plans[0].in_rows],
            "sub_chunk_bytes": s, "objects": N_CLAY_OBJECTS,
            "lost_chunks": n_chunks,
            "launches": counts[name]["gf_bitmatmul_stream"],
            "encode_s": t_encode, "repair_wall_s": wall,
            "per_chunk_s": per_chunk_s, "rebuilt_bytes": rebuilt,
            "rebuilt_GBps": rebuilt / wall / 1e9,
            "host_checked_objects": n_chunks}
        print(f"# clay_repair {name} {plans[0].out_rows} x "
              f"{plans[0].in_rows}: {n_chunks} lost chunks x "
              f"{N_CLAY_OBJECTS} objects, {wall:.4f} s, "
              f"{rebuilt / wall / 1e9:.3f} GB/s rebuilt", flush=True)
        # K4 at the batch's shape at more passes than it needs
        plan = plans[0]
        big = torch.from_numpy(np.concatenate(batches[0], axis=1)).to(dev)
        tab = plan.tables_tensor()
        want = bs.gf_bitmatmul_stream_plain(tab, big)
        fewest = bs.stream_groups(plan.in_rows)
        passes_table = []
        for p in sorted({fewest, 2 * fewest, 4 * fewest}):
            def fn(p=p):
                return bs.gf_bitmatmul_stream(tab, big, groups=p)
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: K4 at {p} passes differs")
            us = graph_event_ms(fn) * 1e3
            passes_table.append({"passes": p, "us": us})
            print(f"# k4_clay_passes {name} passes={p}  {us:9.3f} us",
                  flush=True)
        report[name]["k4_passes"] = passes_table
    merged = {}
    for c in counts.values():
        for key, v in c.items():
            merged[key] = merged.get(key, 0) + v
    return merged, report


# Phase H: the recovery storm.  torch k=8 m=3 over N_STORM_PGS PGs
# sharing one ECLaunchQueue, N_STORM_OBJECTS objects a PG of each size;
# CLAY k=8 m=4 d=11 over 2 PGs of 16 objects of 4 MiB
N_STORM_PGS, N_STORM_OBJECTS = 4, 64
STORM_LOSSES = ((3,), (0, 9))
N_CLAY_STORM_PGS, N_CLAY_STORM_OBJECTS = 2, 16
CLAY_STORM_LOST = 2
# objects a PG recovers at a time (the reference's osd_recovery_max_active
# default for an HDD OSD); every PG's step is submitted before any is
# finalized, as an OSD recovering several PGs at once
STORM_STEP = 3
# the storm's queue window: each step is finalized right after it is
# submitted, so the window only has to outlast a step's submit half (a
# 250 us window fires inside it and launches the first PGs' decodes alone)
STORM_WINDOW_US = 20_000.0


def storm_pgs(dev, queue, plugin: str, profile: dict, n_pgs: int, store):
    """n_pgs ECBackends of one pool (pg_t(2, i)), each with its own codec
    instance, over one MemStore, all submitting to `queue`."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import pg_t
    out = []
    for i in range(n_pgs):
        codec = ErasureCodePluginRegistry.instance().factory(
            plugin, dict(profile))
        k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
        chunk = codec.get_chunk_size(k * STRIPE_UNIT)
        shards = LocalShardBackend(store, pg_t(2, i), n)
        out.append(ECBackend(codec, StripeInfo(k * chunk, chunk), shards,
                             launch_queue=queue, device=dev))
    return out


def storm_write(backends, rng, size: int, n_objects: int) -> dict:
    """n_objects objects of `size` bytes a PG, submitted round-robin over
    the PGs inside one pipeline() window each, so drains of different PGs
    meet in the queue.  Returns {(pg index, name): payload}."""
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t
    objs = {(p, f"o{i}"): np.frombuffer(rng.bytes(size), dtype=np.uint8)
            for i in range(n_objects) for p in range(len(backends))}
    acks = []
    with contextlib.ExitStack() as stack:
        for be in backends:
            stack.enter_context(be.pipeline())
        for v, ((p, name), data) in enumerate(objs.items()):
            txn = PGTransaction()
            txn.write(hobject_t(pool=2, name=name), 0, data)
            backends[p].submit_transaction(
                txn, eversion_t(1, v + 1), lambda: acks.append(1))
    if len(acks) != len(objs):
        raise AssertionError(f"{len(acks)} of {len(objs)} writes acked")
    return objs


def storm_recover(backends, objs, missing) -> dict:
    """Lose `missing` shards of every object, then recover them in steps
    of STORM_STEP objects a PG: every PG's recover_shards_submit before
    any recover_shards_finalize (the two halves of recover_shards_batch),
    as an OSD recovering several PGs at once; each rebuilt shard is pushed back
    to its collection with its recovery xattrs.  Every rebuilt shard must
    equal the lost bytes and its crc32c the stored HashInfo's.  Returns
    the rebuilt bytes and the wall seconds."""
    from ceph_tpu_torch.common import crc32c
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_transaction import shard_oid
    from ceph_tpu_torch.osd.types import hobject_t
    from ceph_tpu_torch.store.object_store import Transaction
    lost = {}
    for (p, name) in objs:
        sh = backends[p].shards
        o = hobject_t(pool=2, name=name)
        for s in missing:
            g = shard_oid(o, s)
            lost[(p, name, s)] = sh.store.read(sh.cids[s], g).copy()
            t = Transaction()
            t.remove(g)
            sh.store.queue_transactions(sh.cids[s], [t])
    pushed = {}

    def push_for(p, name):
        sh = backends[p].shards

        def push(s, data, hinfo):
            g = shard_oid(hobject_t(pool=2, name=name), s)
            t = Transaction()
            t.write(g, 0, data)
            t.setattrs(g, ec_util.recovery_attrs(hinfo, data))
            sh.store.queue_transactions(sh.cids[s], [t])
            pushed[(p, name, s)] = (data, hinfo)
        return push

    items = [[(hobject_t(pool=2, name=name), list(missing))
              for (q, name) in objs if q == p] for p in range(len(backends))]
    t0 = time.perf_counter()
    results = {}
    for lo in range(0, max(map(len, items)), STORM_STEP):
        recs = [be.recover_shards_submit(
            its[lo:lo + STORM_STEP], lambda o, p=p: push_for(p, o.name))
            for p, (be, its) in enumerate(zip(backends, items))]
        for p, (be, rec) in enumerate(zip(backends, recs)):
            for o, err in be.recover_shards_finalize(rec).items():
                results[(p, o.name)] = err
    wall = time.perf_counter() - t0
    bad = {key: err for key, err in results.items() if err is not None}
    if bad or len(results) != len(objs):
        raise AssertionError(f"recovery failed for {len(bad)} objects "
                             f"({len(results)} of {len(objs)} answered): "
                             f"{next(iter(bad.values()), None)!r}")
    nbytes = 0
    for key, want in lost.items():
        data, hinfo = pushed[key]
        if not np.array_equal(data, want):
            raise AssertionError(f"rebuilt shard {key} differs")
        if not hinfo.crc_valid or crc32c.crc32c(data.tobytes()) != \
                hinfo.get_chunk_hash(key[2]):
            raise AssertionError(f"rebuilt shard {key}: crc32c differs "
                                 "from its HashInfo")
        nbytes += data.size
    return {"rebuilt_bytes": nbytes, "wall_s": wall,
            "rebuilt_GBps": nbytes / wall / 1e9}


def storm_snapshot(queue, prof) -> tuple[dict, dict]:
    return queue.status(), prof.perf.dump()


def storm_counts(bs, queue, prof, before) -> dict:
    """Kernel launches, queue status and flight-recorder launches by kind
    since `before` (storm_snapshot), with the seconds the recorded
    launches spent in their submit (for a decode or a repair: staging,
    the kernel and the copy back) and in materialize."""
    before, lat0 = before
    st = queue.status()
    lat = prof.perf.dump()
    launches = st["launches"] - before["launches"]
    return {"kernel_launches": bs.launch_counts(),
            "launch_submit_s": lat["lat_launch_submit"]["sum"]
            - lat0["lat_launch_submit"]["sum"],
            "launch_materialize_s": lat["lat_launch_device"]["sum"]
            - lat0["lat_launch_device"]["sum"],
            "queue_launches": launches,
            "decode_launches": st["decode_launches"]
            - before["decode_launches"],
            "repair_launches": st["repair_launches"]
            - before["repair_launches"],
            "cross_pg_launches": st["cross_pg_launches"]
            - before["cross_pg_launches"],
            "subs_per_launch": (st["submissions"] - before["submissions"])
            / launches if launches else 0.0,
            "profiler_by_kind": prof.profile(last=0)["by_kind"]}


def phase_recovery_storm(dev, rng) -> tuple[dict, dict]:
    """Phase H: the path an OSD-loss storm takes, through one per-host
    ECLaunchQueue on the card.  torch k=8 m=3: N_STORM_PGS PGs x
    N_STORM_OBJECTS objects of 4 MiB (RBD) and of 64 KiB (small S3
    objects) written through the queue (K3 / K2's flat entry), then one
    shard and then shards {0, 9} lost and recovered (K1 decodes through
    the queue).  CLAY k=8 m=4 d=11: 2 PGs x 16 objects of 4 MiB, one
    chunk lost and repaired from repair planes through the queue (K4).
    Kernel launch counters are zeroed before each recovery and each
    write and read after it; every recovery must have run its kernel.
    Returns (launch counts by step, the report)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops.profiler import device_profiler
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.store import MemStore

    prof = device_profiler()
    report = {"card": nvidia_smi_line(), "pgs": N_STORM_PGS,
              "objects_per_pg": N_STORM_OBJECTS}
    counts = {}
    t_phase = time.perf_counter()
    for size, tag in ((BIG, "4MiB"), (SMALL, "64KiB")):
        store = MemStore()
        store.mount()
        queue = ECLaunchQueue(window_us=STORM_WINDOW_US, device=dev)
        try:
            backends = storm_pgs(dev, queue, "torch",
                                 {"k": str(K), "m": str(M),
                                  "device": str(dev)}, N_STORM_PGS, store)
            bs.reset_launch_counts()
            prof.reset()
            before = storm_snapshot(queue, prof)
            t0 = time.perf_counter()
            objs = storm_write(backends, rng, size, N_STORM_OBJECTS)
            torch.cuda.synchronize()
            t_write = time.perf_counter() - t0
            step = storm_counts(bs, queue, prof, before)
            step.update(wall_s=t_write,
                        write_GBps=len(objs) * size / t_write / 1e9)
            counts[f"storm_{tag}_write"] = step["kernel_launches"]
            # 512 KiB runs take K3 at the pinned point, 8 KiB runs K2's
            # flat entry
            entry = "fused_hier_acc_call" if size == BIG \
                else "gf_encode_with_crc_w32"
            if step["kernel_launches"][entry] <= 0 or \
                    step["cross_pg_launches"] <= 0:
                raise AssertionError(f"storm {tag} writes: no {entry} "
                                     f"launch across PGs: {step}")
            report[f"{tag}_write"] = step
            for missing in STORM_LOSSES:
                name = f"storm_{tag}_lose{''.join(map(str, missing))}"
                bs.reset_launch_counts()
                prof.reset()
                before = storm_snapshot(queue, prof)
                res = storm_recover(backends, objs, missing)
                res.update(storm_counts(bs, queue, prof, before))
                counts[name] = res["kernel_launches"]
                if counts[name]["gf_bitmatmul"] <= 0 or \
                        res["decode_launches"] <= 0:
                    raise AssertionError(f"{name}: no K1 decode launch")
                report[name] = res
                print(f"# {name}: {res['rebuilt_bytes']} B rebuilt in "
                      f"{res['wall_s']:.4f} s, {res['rebuilt_GBps']:.3f} "
                      f"GB/s, {res['decode_launches']} decode launches, "
                      f"{res['cross_pg_launches']} cross-PG", flush=True)
            report[f"{tag}_queue"] = queue.status()
        finally:
            queue.close()
    if report["storm_64KiB_lose3"]["cross_pg_launches"] < 1:
        raise AssertionError("the small-object storm coalesced no decode "
                             "across PGs")
    # CLAY k=8 m=4 d=11: one chunk lost, repaired through the queue (K4)
    ck, cm, cd = CLAY_PROFILES["k8m4d11"]
    store = MemStore()
    store.mount()
    queue = ECLaunchQueue(window_us=STORM_WINDOW_US, device=dev)
    try:
        backends = storm_pgs(dev, queue, "clay",
                             {"k": str(ck), "m": str(cm), "d": str(cd)},
                             N_CLAY_STORM_PGS, store)
        t0 = time.perf_counter()
        objs = storm_write(backends, rng, BIG, N_CLAY_STORM_OBJECTS)
        t_write = time.perf_counter() - t0
        bs.reset_launch_counts()
        prof.reset()
        before = storm_snapshot(queue, prof)
        res = storm_recover(backends, objs, (CLAY_STORM_LOST,))
        res.update(storm_counts(bs, queue, prof, before))
        res["host_encode_write_s"] = t_write
        res["clay_repairs"] = sum(be.repair_status()["clay_repairs"]
                                  for be in backends)
        counts["storm_clay_k8m4d11"] = res["kernel_launches"]
        if counts["storm_clay_k8m4d11"]["gf_bitmatmul_stream"] <= 0 or \
                res["repair_launches"] <= 0 or \
                res["clay_repairs"] != len(objs):
            raise AssertionError(f"CLAY storm did not repair through K4: "
                                 f"{res}")
        report["storm_clay_k8m4d11"] = res
        print(f"# storm_clay_k8m4d11: {res['rebuilt_bytes']} B rebuilt in "
              f"{res['wall_s']:.4f} s, {res['rebuilt_GBps']:.3f} GB/s, "
              f"{res['repair_launches']} repair launches", flush=True)
    finally:
        queue.close()
    report["phase_s"] = time.perf_counter() - t_phase
    return counts, report


# Phase I: the reference's deep-scrub bench setting (bench.py
# time_deep_scrub at its card sizes): k=8 m=3, objects of 8 MiB, a
# 16 KiB stripe unit, so 1 MiB shard rows, scrub chunks of
# SCRUB_CHUNK_BYTES (64 MiB)
SCRUB_OBJECT = 8 << 20
SCRUB_STRIPE_UNIT = 16 << 10
N_SCRUB_PGS = 4
N_SCRUB_OBJECTS = 16
# tail objects: with a 4 or 16 KiB stripe unit every shard row is whole
# 2 KiB blocks, so a fifth PG with a 1 KiB unit holds 8 objects of
# 8 MiB + 777 B, whose rows end in a 1 KiB tail the host folds
SCRUB_TAIL_UNIT = 1 << 10
SCRUB_TAIL_SIZE = (8 << 20) + 777
N_SCRUB_TAIL_OBJECTS = 8
# the rot: (PG, object, shard), data and parity shards of different
# objects, the last one a byte in a tail (5 bytes before the row's end)
SCRUB_ROT = ((0, 1, 0), (0, 7, 9), (1, 2, 3), (1, 13, 10), (2, 5, 5),
             (3, 0, 7), (3, 15, 1), (4, 3, 2))


def scrub_pgs(dev, store) -> list:
    """The backends of phase I on the card over one MemStore: torch k=8
    m=3 at the pinned K3 point, N_SCRUB_PGS PGs with the 16 KiB stripe
    unit and one with the 1 KiB unit of the tail objects."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import pg_t
    out = []
    units = [SCRUB_STRIPE_UNIT] * N_SCRUB_PGS + [SCRUB_TAIL_UNIT]
    for i, unit in enumerate(units):
        codec = ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": str(K), "m": str(M), "device": str(dev)})
        shards = LocalShardBackend(store, pg_t(3, i), K + M)
        out.append(ECBackend(codec, StripeInfo(K * unit, unit), shards,
                             device=dev))
    return out


def scrub_chunks(row_bytes: list[int]) -> int:
    """K5 launches scrub_pg makes over objects of `row_bytes` shard rows
    (k+m rows each): its chunk budget closes a chunk at
    SCRUB_CHUNK_BYTES."""
    from ceph_tpu_torch.osd.scrub import SCRUB_CHUNK_BYTES
    chunks = budget = 0
    for n in row_bytes:
        budget += n * (K + M)
        if budget >= SCRUB_CHUNK_BYTES:
            chunks, budget = chunks + 1, 0
    return chunks + (budget > 0)


def scrub_all(backends, oids, **kw) -> tuple[list, float]:
    """Deep-scrub every PG of phase I; (results, wall seconds)."""
    from ceph_tpu_torch.osd import scrub
    t0 = time.perf_counter()
    res = [scrub.scrub_pg(be, o, deep=True, **kw)
           for be, o in zip(backends, oids)]
    return res, time.perf_counter() - t0


def phase_deep_scrub(dev, rng) -> tuple[dict, dict]:
    """Phase I: deep scrub of 4 PGs x 16 objects of 8 MiB (704 MiB of
    shards) and one PG of 8 objects of 8 MiB + 777 B, written on the
    card.  A clean scrub (one K5 launch a 64 MiB chunk, tails folded on
    the host) must find nothing; then 8 shards rot (SCRUB_ROT) and a
    scrub with repair must find each as crc_mismatch on its shard and
    rebuild it (K1) to its original bytes; then the same PGs on the
    host crc32c, and the device path once more.  Returns (launch counts
    by step, the report)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction, shard_oid
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t
    from ceph_tpu_torch.store import MemStore
    from ceph_tpu_torch.store.object_store import Transaction

    store = MemStore()
    store.mount()
    backends = scrub_pgs(dev, store)
    sizes = [SCRUB_OBJECT] * N_SCRUB_PGS + [SCRUB_TAIL_SIZE]
    n_objs = [N_SCRUB_OBJECTS] * N_SCRUB_PGS + [N_SCRUB_TAIL_OBJECTS]
    oids, acks = [], []
    t0 = time.perf_counter()
    for p, (be, size, n) in enumerate(zip(backends, sizes, n_objs)):
        oids.append([hobject_t(pool=3, name=f"s{p}_{i}") for i in range(n)])
        with be.pipeline():
            for i, o in enumerate(oids[-1]):
                txn = PGTransaction()
                txn.write(o, 0, np.frombuffer(rng.bytes(size),
                                              dtype=np.uint8))
                be.submit_transaction(txn, eversion_t(1, i + 1),
                                      lambda: acks.append(1))
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    if len(acks) != sum(n_objs):
        raise AssertionError(f"{len(acks)} of {sum(n_objs)} writes acked")
    rows = [[be.shards.stat(0, o) for o in os_]
            for be, os_ in zip(backends, oids)]
    shard_bytes = sum(sum(r) for r in rows) * (K + M)
    tail_bytes = sum(n % 2048 for r in rows for n in r) * (K + M)
    want_k5 = sum(scrub_chunks(r) for r in rows)
    counts = {}
    report = {"card": nvidia_smi_line(), "pgs": len(backends),
              "objects": sum(n_objs), "shard_bytes": shard_bytes,
              "write_s": t_write}

    def check_clean(res, tag):
        bad = [e for r in res for e in r.errors]
        if bad or sum(r.objects for r in res) != sum(n_objs):
            raise AssertionError(f"{tag}: {len(bad)} errors, first "
                                 f"{bad[:1]!r}")

    # 1. the clean PGs
    bs.reset_launch_counts()
    res, wall = scrub_all(backends, oids)
    counts["deep_scrub"] = bs.launch_counts()
    check_clean(res, "clean scrub")
    dev_b = sum(r.device_bytes for r in res)
    host_b = sum(r.host_bytes for r in res)
    k5 = counts["deep_scrub"]["crc32c_rows_l"]
    if dev_b + host_b != shard_bytes or host_b != tail_bytes or \
            k5 != want_k5:
        raise AssertionError(f"clean scrub: {dev_b} device + {host_b} host "
                             f"bytes of {shard_bytes} ({tail_bytes} in "
                             f"tails), {k5} K5 launches of {want_k5}")
    report["device"] = {"wall_s": wall, "GBps": shard_bytes / wall / 1e9,
                        "k5_launches": k5, "device_bytes": dev_b,
                        "host_bytes": host_b}
    # 2. rot: flip bytes in 8 shards
    original, rotted = {}, set()
    for p, i, s in SCRUB_ROT:
        sh = backends[p].shards
        g = shard_oid(oids[p][i], s)
        data = sh.store.read(sh.cids[s], g)
        original[(p, i, s)] = data.copy()
        off = data.size - 5 if p == N_SCRUB_PGS else 4099
        t = Transaction()
        t.write(g, off, np.array([data[off] ^ 0xA5], dtype=np.uint8))
        sh.store.queue_transactions(sh.cids[s], [t])
        rotted.add((oids[p][i].name, s))
    # 3. scrub with repair
    bs.reset_launch_counts()
    res, wall_r = scrub_all(backends, oids, repair=True)
    counts["deep_scrub_repair"] = bs.launch_counts()
    check_clean(res, "repair scrub")
    found = {(e.oid.name, e.shard) for r in res for e in r.repaired
             if e.kind == "crc_mismatch"}
    kinds = {e.kind for r in res for e in r.repaired}
    if found != rotted or kinds != {"crc_mismatch"}:
        raise AssertionError(f"repair found {sorted(found)} ({kinds}), "
                             f"rotted {sorted(rotted)}")
    for (p, i, s), want in original.items():
        sh = backends[p].shards
        if not np.array_equal(sh.store.read(sh.cids[s],
                                            shard_oid(oids[p][i], s)), want):
            raise AssertionError(f"shard {s} of {oids[p][i].name} was not "
                                 "restored")
    k1 = counts["deep_scrub_repair"]["gf_bitmatmul"]
    if k1 <= 0:
        raise AssertionError("repair decoded through no K1 launch")
    report["repair"] = {"wall_s": wall_r, "rotted": len(rotted),
                        "repaired": len(found), "k1_launches": k1,
                        "k5_launches":
                        counts["deep_scrub_repair"]["crc32c_rows_l"]}
    # 4. the host path (native crc32c) on the same PGs, then the device
    # path once more
    res, wall_h = scrub_all(backends, oids, use_device=False)
    check_clean(res, "host scrub")
    if sum(r.host_bytes for r in res) != shard_bytes:
        raise AssertionError("host scrub did not verify every byte")
    report["host"] = {"wall_s": wall_h, "GBps": shard_bytes / wall_h / 1e9}
    res, wall_2 = scrub_all(backends, oids)
    check_clean(res, "second device scrub")
    report["device_again"] = {"wall_s": wall_2,
                              "GBps": shard_bytes / wall_2 / 1e9}
    print(f"# deep scrub: {shard_bytes} B verified; device path "
          f"{wall:.4f} s {report['device']['GBps']:.3f} GB/s (again "
          f"{wall_2:.4f} s {report['device_again']['GBps']:.3f} GB/s), "
          f"host path {wall_h:.4f} s {report['host']['GBps']:.3f} GB/s; "
          f"{k5} K5 launches, {dev_b} device B, {host_b} host B; repair "
          f"{len(found)}/{len(rotted)} shards with {k1} K1 launches",
          flush=True)
    return counts, report


# Graph times of the two K3 rows before K3's redesign (PERF.md §6:
# chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W), the `earlier`
# column of the K3 table
K3_EARLIER_US = {"gf_encode_crc_acc (K3, one 512 KiB run)": 20.672,
                 "gf_encode_crc_acc (K3, 2 runs, one odd-width)": 29.206}


def k3_block_table(dev, bs, gf, rng, rows) -> dict:
    """K3 on one 8+3 x 512 KiB run at B = 1, 2 and 4 KiB (the
    autotuner's wb 256, 512, 1024): the wrapper (its L zero-fill plus
    the kernel), the kernel alone (the C entry on a slot zeroed once,
    its XORs left to pile up while timed), and K2's hier entry at the
    same block as this run's control; each checked exactly against its
    plain version, then timed as the kernel rows are (graph replays).
    Also the zero-fill of the L slots alone, and the two K3 kernel rows
    beside their times before the redesign."""
    from ceph_tpu_torch.ops import _build
    lib = _build.load()
    enc = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(K, M)[K:]),
                           dev)
    run = BIG // K
    data = torch.from_numpy(
        rng.integers(0, 256, (K, run), dtype=np.uint8)).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fill_us = graph_event_ms(lambda: torch.zeros(
        (1, K + M), dtype=torch.int64, device=dev)) * 1e3
    by_block = []
    for wb in (256, 512, 1024):
        block = 4 * wb
        staged, ends = bs._acc_launch_args([run // block], dev)
        torch.cuda.synchronize()
        del staged
        want = bs.fused_hier_acc_call_plain(enc, data, ends, wb)
        got = bs.fused_hier_acc_call(enc, data, ends, wb)
        k2, k2_want = (bs.fused_hier_call(enc, data, wb),
                       bs.fused_hier_call_plain(enc, data, wb))
        ops = bs._k3_ops_tensor(block, dev)
        parity = torch.empty((M, run), dtype=torch.uint8, device=dev)
        lacc = torch.zeros((1, K + M), dtype=torch.int64, device=dev)

        def alone():
            rc = lib.ctt_gf_encode_crc_acc(
                enc.data_ptr(), data.data_ptr(), parity.data_ptr(),
                lacc.data_ptr(), ops.data_ptr(), ends.data_ptr(), 1, M, K,
                run, block, bs.K3_DIGITS,
                torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
        alone()
        torch.cuda.synchronize()
        for name, a, b in (("K3", got, want), ("K3 alone", (parity, lacc),
                                                want), ("K2 hier", k2,
                                                        k2_want)):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{name} at B = {block} differs from "
                                     "its plain version")
        t_bound, _ = bound(K * run + M * run + (K + M) * 8,
                           2 * M * K * run + 2 * (K + M) * run)
        row = {"block": block, "wb": wb,
               "grid": bs.k3_launch(run, block, K, M, sms),
               "k3_us": graph_event_ms(
                   lambda: bs.fused_hier_acc_call(enc, data, ends, wb)) * 1e3,
               "k3_alone_us": graph_event_ms(alone) * 1e3,
               "k2_hier_us": graph_event_ms(
                   lambda: bs.fused_hier_call(enc, data, wb)) * 1e3,
               "bound_us": t_bound * 1e3}
        by_block.append(row)
        print(f"# k3_table B={block:5d} grid={row['grid']:4d}  K3 "
              f"{row['k3_us']:8.3f} us  alone {row['k3_alone_us']:8.3f} us  "
              f"K2 hier {row['k2_hier_us']:8.3f} us  bound "
              f"{row['bound_us']:.3f} us", flush=True)
    print(f"# k3_table L zero-fill alone {fill_us:.3f} us", flush=True)
    earlier = [{"name": r["name"], "earlier_us": K3_EARLIER_US[r["name"]],
                "us": r["ms"] * 1e3, "single_us": r["single_ms"] * 1e3,
                "cold_us": r["cold_ms"] * 1e3, "bound_us": r["bound_ms"] * 1e3}
               for r in rows if r["name"] in K3_EARLIER_US]
    if len(earlier) != 2:
        raise AssertionError(f"K3 rows missing: {[r['name'] for r in rows]}")
    return {"fill_us": fill_us, "by_block": by_block, "rows": earlier}


# Graph times of the K2 and K3 rows before K2's redesign (the final
# chip_smoke.py run of K3's redesign on an NVIDIA H100 80GB HBM3 at
# 700 W: PERF.md §6's rows and its K3 table's K2 control at B = 2 and
# 4 KiB; 1 KiB not recorded), the `earlier` column of the K2 table
K2_EARLIER_US = {"fused_hier_call (K2, 2 KiB sub-blocks)": 17.085,
                 "gf_encode_with_crc_w32 (K2, 2 KiB tiles)": 13.936,
                 "gf_encode_with_crc (K2 byte entry, 2 KiB tiles)": 17.014,
                 "gf_encode_crc_acc (K3, one 512 KiB run)": 12.538,
                 "gf_encode_crc_acc (K3, 2 runs, one odd-width)": 19.034}
K2_EARLIER_BLOCK_US = {1024: None, 2048: 17.14, 4096: 21.77}


def k2_block_table(bs, sms: int, k3_table: dict, rows) -> dict:
    """K2 against its times before the redesign: its hier entry on one
    8+3 x 512 KiB run at B = 1, 2 and 4 KiB (checked exactly against
    its plain version and timed by k3_block_table) with its grid, and
    its three kernel rows; K3 at the same blocks and K3's kernel rows
    as this run's control."""
    run = BIG // K
    by_block = []
    for r in k3_table["by_block"]:
        row = {"block": r["block"], "wb": r["wb"],
               "grid": bs.k3_launch(run, r["block"], K, M, sms, acc=False),
               "us": r["k2_hier_us"],
               "earlier_us": K2_EARLIER_BLOCK_US[r["block"]],
               "k3_us": r["k3_us"], "k3_alone_us": r["k3_alone_us"],
               "bound_us": r["bound_us"]}
        by_block.append(row)
        print(f"# k2_table B={row['block']:5d} grid={row['grid']:4d}  K2 "
              f"hier {row['us']:8.3f} us (earlier {row['earlier_us']})  K3 "
              f"alone {row['k3_alone_us']:8.3f} us", flush=True)
    kernel_rows = [{"name": r["name"], "earlier_us": K2_EARLIER_US[r["name"]],
                    "control": r["name"] in K3_EARLIER_US,
                    "us": r["ms"] * 1e3, "single_us": r["single_ms"] * 1e3,
                    "cold_us": r["cold_ms"] * 1e3,
                    "bound_us": r["bound_ms"] * 1e3}
                   for r in rows if r["name"] in K2_EARLIER_US]
    if len(kernel_rows) != 5:
        raise AssertionError(f"K2/K3 rows missing: "
                             f"{[r['name'] for r in rows]}")
    for r in kernel_rows:
        print(f"# k2_table {r['name']}: {r['us']:.3f} us (earlier "
              f"{r['earlier_us']})", flush=True)
    return {"by_block": by_block, "rows": kernel_rows}


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


def k1_thread_bytes_table(dev, rng) -> list[dict]:
    """K1 at 4 and 16 bytes of each row a thread and at k1_launch's pick,
    and K4 forced to 1, 2, 4 and 8 passes of the 8 source rows (the
    multi-pass path at #7's own shape), over widths of 16 KiB - 4 MiB a
    row (8 -> 3, the write path's Cauchy code; 256 and 512 KiB sit
    either side of k1_launch's threshold), each at its default grid.  Each entry
    checked against K1's plain version, then timed as the kernel rows
    are (graph replays)."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    enc = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(K, M)[K:]),
                           dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table = []
    for width in (16 << 10, 128 << 10, 256 << 10, 512 << 10, 4 << 20):
        data = torch.from_numpy(
            rng.integers(0, 256, (K, width), dtype=np.uint8)).to(dev)
        want = bs.gf_bitmatmul_plain(enc, data)
        pick = bs.k1_launch(width, K, M, sms)
        print(f"# k1_launch row={width:8d} B  picks {pick[0]} bytes a "
              f"thread, {pick[1]} blocks", flush=True)
        variants = [(f"K1 {tb} B", tb, lambda tb=tb: bs.gf_bitmatmul(
            enc, data, thread_bytes=tb)) for tb in (4, 16)]
        variants.append(("K1 pick", pick[0],
                         lambda: bs.gf_bitmatmul(enc, data)))
        variants += [(f"K4 P={g}", None, lambda g=g: bs.gf_bitmatmul_stream(
            enc, data, groups=g)) for g in (1, 2, 4, 8)]
        for name, tb, fn in variants:
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name} at {width} B differs")
            us = graph_event_ms(fn) * 1e3
            row = {"kernel": name, "row_bytes": width, "us": us,
                   "GBps": K * width / us / 1e3}
            if tb is not None:
                row["thread_bytes"] = tb
                row["blocks"] = bs.k1_launch(width, K, M, sms,
                                             thread_bytes=tb)[1]
            table.append(row)
            print(f"# k1_table {name:8s} row={width:8d} B  {us:9.3f} us  "
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
    k3_table = k3_block_table(dev, bs, gf, rng, rows)
    k2_table = k2_block_table(
        bs, torch.cuda.get_device_properties(dev).multi_processor_count,
        k3_table, rows)
    bs._encode_crc_launch.narrow_launches = 0
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
        k1_table = k1_thread_bytes_table(dev, rng)
        counts["clay_repair"], clay = phase_clay_repair(dev, rng)
        pin_point(tmp / "pinned_storm.json", dev,
                  dict(autotune.default_point(), combine="kernel"))
        storm_counts, storm = phase_recovery_storm(dev, rng)
        scrub_counts, scrub = phase_deep_scrub(dev, rng)
        counts.update(scrub_counts)
        ab = phase_ab()
        narrow_launches = bs._encode_crc_launch.narrow_launches
    finally:
        os.environ.pop("CEPH_TPU_AUTOTUNE_CACHE", None)
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        phase = row.pop("phase")
        counter = row.pop("counter")
        if counter is None:
            # K2's narrow branch: its launches over every phase
            row["launches"] = narrow_launches
            row["recovery_storm_launches"] = None
            continue
        row["launches"] = counts[phase][counter]
        row["recovery_storm_launches"] = sum(
            c[counter] for c in storm_counts.values())
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on its "
                                 f"phase ({phase})")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"k3_table": k3_table}), flush=True)
    print(json.dumps({"k2_table": k2_table}), flush=True)
    print(json.dumps({"sweep": sweep}), flush=True)
    print(json.dumps({"main_path_xla": perf_xla}), flush=True)
    print(json.dumps({"main_path_kernel": perf_kernel,
                      "write_ab": perf_pick}), flush=True)
    print(json.dumps({"main_path_bytes": perf_bytes}), flush=True)
    print(json.dumps({"ec_benchmark": bench, "launch_counts": counts}),
          flush=True)
    print(json.dumps({"w32_sweep": w32_rows, "k1_thread_bytes": k1_table}),
          flush=True)
    print(json.dumps({"clay_repair": clay}), flush=True)
    print(json.dumps({"recovery_storm": storm,
                      "recovery_storm_launch_counts": storm_counts}),
          flush=True)
    print(json.dumps({"deep_scrub": scrub,
                      "deep_scrub_launch_counts": scrub_counts}),
          flush=True)
    print(json.dumps({"ec_benchmark_ab": ab}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

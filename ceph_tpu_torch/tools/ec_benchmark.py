"""Erasure-code benchmark CLI.

The port of ceph_tpu/tools/ec_benchmark.py, itself the flag- and
output-compatible reimplementation of the reference's
`ceph_erasure_code_benchmark` (src/test/erasure-code/
ceph_erasure_code_benchmark.cc:40-144 options, :184/:315 output):

  -p/--plugin NAME        codec plugin (jerasure (default), isa, example,
                          torch)
  -P/--parameter K=V      profile entries, repeatable (k=8, m=3; torch:
                          device=cpu|cuda)
  -S/--size BYTES         object size to encode per iteration
  -i/--iterations N       iterations
  -w/--workload encode|decode
  -e/--erasures N         chunks to erase in decode workload
  -N/--erased I           specific chunk index to erase, repeatable
  -E/--erasures-generation random|exhaustive
  -v/--verbose

Output contract preserved: "<elapsed_seconds>\t<iterations*(size/1024)>"
(seconds TAB total KiB processed).  --gbps appends a GB/s line to
stderr; --batch B folds B stripes into one launch (`encode_stripes`).

The CPU plugins run the reference's loop: N synchronous encode_chunks
calls over one host buffer, and for decode N host `decode` calls.  On
the torch plugin the encode workload runs on device tensors through its
device-resident entries (`encode_chunks_device`, `encode_stripes`: K1,
the counterpart of Pallas kernel #5), synchronising the card once at
the end of the timed loop.  The decode workload does the same through
`decode_chunks_device` (K1 with the erasure set's recovery tables):
each timed call rebuilds the erased chunks from k survivor chunks
already on the card.  Before timing, every erasure combination is
decoded through the plugin's host `decode` and through the device entry
and checked byte for byte — with -E exhaustive, all of them, like the
reference's decode_erasures recursion (:202-231).

--ab times the CPU-best plugin (isa, else jerasure cauchy_good) against
torch under one synchronous host-buffer loop, per call and batched,
and prints one JSON row each plus the two `torch_over_cpu` ratio rows
(ceph_tpu names that key `jax_over_cpu`).  --min-time sets its
seconds per side and mode.

python -m ceph_tpu_torch.tools.ec_benchmark -P k=8 -P m=3 -S 1048576 -i 1000
python -m ceph_tpu_torch.tools.ec_benchmark -p torch -P k=8 -P m=3 \
    -S 1048576 -i 1000
python -m ceph_tpu_torch.tools.ec_benchmark --ab -P k=8 -P m=3 \
    -S 1048576 --batch 32
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="ec_benchmark")
    ap.add_argument("-p", "--plugin", default="jerasure")
    ap.add_argument("-P", "--parameter", action="append", default=[],
                    metavar="K=V")
    ap.add_argument("-S", "--size", type=int, default=1 << 20)
    ap.add_argument("-i", "--iterations", type=int, default=1)
    ap.add_argument("-w", "--workload", choices=("encode", "decode"),
                    default="encode")
    ap.add_argument("-e", "--erasures", type=int, default=1)
    ap.add_argument("-N", "--erased", action="append", type=int, default=[])
    ap.add_argument("-E", "--erasures-generation", dest="erasures_generation",
                    choices=("random", "exhaustive"), default="random")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--gbps", action="store_true")
    ap.add_argument("--ab", action="store_true",
                    help="symmetric A/B: time CPU-best and torch plugins "
                         "under the same synchronous host-buffer loop, "
                         "per-call and batched; JSON row each")
    ap.add_argument("--min-time", dest="min_time", type=float, default=2.0,
                    help="--ab: seconds timed per side and mode")
    return ap.parse_args(argv)


def make_codec(plugin: str, parameters: list[str]):
    from ..ec import ErasureCodePluginRegistry
    profile = {}
    for p in parameters:
        if "=" not in p:
            raise SystemExit(f"--parameter {p!r} is not K=V")
        k, v = p.split("=", 1)
        profile[k] = v
    return ErasureCodePluginRegistry.instance().factory(plugin, profile)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_encode_loop(codec, chunks_np, iterations, batch):
    """Steady-state device-resident encode timing: one warm call, then
    max(1, iterations // batch) calls, one card synchronisation."""
    dev = codec.device
    k, cs = chunks_np.shape
    if batch > 1:
        fn = codec.encode_stripes
        arg = torch.from_numpy(
            np.broadcast_to(chunks_np, (batch, k, cs)).copy()).to(dev)
    else:
        fn = codec.encode_chunks_device
        arg = torch.from_numpy(chunks_np).to(dev)
    fn(arg)
    _sync(dev)
    calls = max(1, iterations // batch)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(arg)
    _sync(dev)
    return time.perf_counter() - t0, calls * batch


def run_encode(codec, args) -> tuple[float, int]:
    rng = np.random.default_rng(55)
    payload = rng.integers(0, 256, args.size, dtype=np.uint8).tobytes()
    chunks = codec.encode_prepare(payload)
    if hasattr(codec, "encode_chunks_device"):
        return _device_encode_loop(codec, chunks, args.iterations, args.batch)
    codec.encode_chunks(chunks)  # warm the tables
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        codec.encode_chunks(chunks)
    return time.perf_counter() - t0, args.iterations


def run_decode(codec, args) -> tuple[float, int]:
    n = codec.get_chunk_count()
    rng = np.random.default_rng(56)
    payload = rng.integers(0, 256, args.size, dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(n)), payload)
    cs = len(encoded[0])

    if args.erasures_generation == "exhaustive":
        combos = list(itertools.combinations(range(n), args.erasures))
    elif args.erased:
        combos = [tuple(args.erased)]
    else:
        combos = [tuple(sorted(rng.choice(n, args.erasures, replace=False)
                               .tolist()))]
    # verify every combination through the host decode (warming the
    # decode-plan caches) and, on the torch plugin, through the device
    # entry, staging the survivors
    for erased in combos:
        avail = {i: encoded[i] for i in range(n) if i not in erased}
        dec = codec.decode(set(range(n)), avail, cs)
        for i in range(n):
            np.testing.assert_array_equal(dec[i], encoded[i])
    if not hasattr(codec, "decode_chunks_device"):
        t0 = time.perf_counter()
        for it in range(args.iterations):
            erased = combos[it % len(combos)]
            avail = {i: encoded[i] for i in range(n) if i not in erased}
            codec.decode(set(range(n)), avail, cs)
        return time.perf_counter() - t0, args.iterations
    dev = codec.device
    k = codec.get_data_chunk_count()
    staged = []
    for erased in combos:
        survivors = tuple(i for i in range(n) if i not in erased)[:k]
        rows = torch.from_numpy(
            np.stack([encoded[i] for i in survivors])).to(dev)
        rec = codec.decode_chunks_device(rows, survivors, erased)
        np.testing.assert_array_equal(
            rec.cpu().numpy(), np.stack([encoded[e] for e in erased]))
        staged.append((rows, survivors, erased))

    _sync(dev)
    t0 = time.perf_counter()
    for it in range(args.iterations):
        rows, survivors, erased = staged[it % len(staged)]
        codec.decode_chunks_device(rows, survivors, erased)
    _sync(dev)
    return time.perf_counter() - t0, args.iterations


# -- symmetric A/B: one harness, one accounting -----------------------------

def _time_sync_encode(codec, bufs, min_iters=5, min_time=2.0):
    """Synchronous per-call encode timing over host buffers.  The same
    loop runs for every side: each iteration is one encode_chunks call
    on a distinct host-resident input, so the torch side pays its copy
    to the card and back exactly where the CPU side pays its memory
    traffic.  Mirrors the reference benchmark loop
    (ceph_erasure_code_benchmark.cc:146-186: N synchronous encode()
    calls over an in-memory buffer)."""
    codec.encode_chunks(bufs[0])          # warm tables / build kernels
    t0 = time.perf_counter()
    iters = 0
    while iters < min_iters or time.perf_counter() - t0 < min_time:
        codec.encode_chunks(bufs[iters % len(bufs)])
        iters += 1
    return iters, time.perf_counter() - t0


def ab_rows(k: int, m: int, size: int, batch: int = 32,
            min_time: float = 2.0, device: str = "cuda") -> list[dict]:
    """Symmetric A/B matrix: {cpu-best, torch} x {per_call, batched}.

    per_call: one `size`-byte object per iteration (the reference loop's
    shape).  batched: one (k, batch*chunk) call per iteration — the
    batch rides the byte axis for both sides, so loop shape and
    accounting stay identical and only the payload width changes.
    Throughput is input bytes/s; ratios are taken within one mode."""
    from ..ec import ErasureCodeError, ErasureCodePluginRegistry
    reg = ErasureCodePluginRegistry.instance()
    prof = {"k": str(k), "m": str(m)}
    cpu_best = None
    for plugin, p in (("isa", dict(prof)),
                      ("jerasure", dict(prof, technique="cauchy_good"))):
        try:
            cpu_best = (plugin, reg.factory(plugin, p))
            break
        except ErasureCodeError:
            continue
    if cpu_best is None:
        raise RuntimeError("no CPU plugin available for the A/B "
                           "denominator (isa and jerasure both failed)")
    torch_codec = reg.factory("torch", dict(prof, device=device))

    rng = np.random.default_rng(77)
    chunk = size // k
    nbufs = 4
    rows = []
    for mode, width in (("per_call", chunk), ("batched", batch * chunk)):
        bufs = [rng.integers(0, 256, (k, width), dtype=np.uint8)
                for _ in range(nbufs)]
        for name, codec in (cpu_best, ("torch", torch_codec)):
            iters, dt = _time_sync_encode(codec, bufs, min_time=min_time)
            rows.append({
                "side": name, "mode": mode,
                "bytes_per_iter": k * width, "iters": iters,
                "gbps": round(iters * k * width / dt / 1e9, 3),
            })
    by = {(r["side"], r["mode"]): r["gbps"] for r in rows}
    for mode in ("per_call", "batched"):
        rows.append({
            "ratio_mode": mode,
            "torch_over_cpu": round(by[("torch", mode)] /
                                    by[(cpu_best[0], mode)], 3),
        })
    return rows


def run_ab(args) -> int:
    import json
    prof = dict(p.split("=", 1) for p in args.parameter if "=" in p)
    for row in ab_rows(int(prof.get("k", 8)), int(prof.get("m", 3)),
                       args.size, batch=max(args.batch, 2),
                       min_time=args.min_time,
                       device=prof.get("device") or "cuda"):
        print(json.dumps(row))
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..ec import ErasureCodeError
    if args.ab:
        try:
            return run_ab(args)
        except (ErasureCodeError, RuntimeError) as e:
            print(f"ec_benchmark: {e}", file=sys.stderr)
            return 1
    try:
        codec = make_codec(args.plugin, args.parameter)
    except (ErasureCodeError, RuntimeError) as e:
        print(f"ec_benchmark: {e}", file=sys.stderr)
        return 1
    if args.verbose:
        print(f"plugin={args.plugin} k={codec.get_data_chunk_count()} "
              f"m={codec.get_coding_chunk_count()} size={args.size} "
              f"iterations={args.iterations} "
              f"device={getattr(codec, 'device', 'host')}",
              file=sys.stderr)
    try:
        if args.workload == "encode":
            elapsed, iters = run_encode(codec, args)
        else:
            elapsed, iters = run_decode(codec, args)
    except ErasureCodeError as e:
        print(f"ec_benchmark: {e}", file=sys.stderr)
        return 1
    total_kib = iters * (args.size // 1024)
    print(f"{elapsed:.6f}\t{total_kib}")
    if args.gbps:
        gbs = iters * args.size / elapsed / 1e9 if elapsed > 0 \
            else float("inf")
        print(f"# {gbs:.3f} GB/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

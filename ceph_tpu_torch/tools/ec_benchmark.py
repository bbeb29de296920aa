"""Erasure-code benchmark CLI on the torch plugin.

The port of ceph_tpu/tools/ec_benchmark.py, itself the flag- and
output-compatible reimplementation of the reference's
`ceph_erasure_code_benchmark` (src/test/erasure-code/
ceph_erasure_code_benchmark.cc:40-144 options, :184/:315 output):

  -p/--plugin NAME        codec plugin (default and only one: torch)
  -P/--parameter K=V      profile entries, repeatable (k=8, m=3,
                          device=cpu|cuda, ...)
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

The encode workload runs on device tensors through the plugin's
device-resident entries (`encode_chunks_device`, `encode_stripes`: K1,
the counterpart of Pallas kernel #5), synchronising the card once at
the end of the timed loop.  The decode workload does the same through
`decode_chunks_device` (K1 with the erasure set's recovery tables):
each timed call rebuilds the erased chunks from k survivor chunks
already on the card.  Before timing, every erasure combination is
decoded through the plugin's host `decode` and through the device entry
and checked byte for byte — with -E exhaustive, all of them, like the
reference's decode_erasures recursion (:202-231).

python -m ceph_tpu_torch.tools.ec_benchmark -P k=8 -P m=3 -S 1048576 -i 1000
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
    ap.add_argument("-p", "--plugin", default="torch")
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
                    help="A/B against the CPU plugins (not in the port yet)")
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
    return _device_encode_loop(codec, chunks, args.iterations, args.batch)


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
    # verify every combination through the host decode and the device
    # entry (warming the decode-plan cache), staging the survivors
    dev = codec.device
    k = codec.get_data_chunk_count()
    staged = []
    for erased in combos:
        avail = {i: encoded[i] for i in range(n) if i not in erased}
        dec = codec.decode(set(range(n)), avail, cs)
        for i in range(n):
            np.testing.assert_array_equal(dec[i], encoded[i])
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


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..ec import ErasureCodeError
    if args.ab:
        print("ec_benchmark: --ab needs the CPU plugins (isa, jerasure), "
              "which ceph_tpu_torch does not have yet", file=sys.stderr)
        return 2
    try:
        codec = make_codec(args.plugin, args.parameter)
    except (ErasureCodeError, RuntimeError) as e:
        print(f"ec_benchmark: {e}", file=sys.stderr)
        return 1
    if args.verbose:
        print(f"plugin={args.plugin} k={codec.get_data_chunk_count()} "
              f"m={codec.get_coding_chunk_count()} size={args.size} "
              f"iterations={args.iterations} device={codec.device}",
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

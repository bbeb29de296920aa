"""Tile/variant sweep of the GF(2^8) encode kernels on the card.

The port of ceph_tpu/tools/w32_sweep.py, which timed the word-packed
Pallas encode kernel across per-chunk tiles for the all-planes kernel
(stream=False, Pallas #3) and the streaming-accumulation kernel
(stream=True, Pallas #7).  Here variant 0 is their counterpart K1
(`gf_bitmatmul`) and variant 1 is K4 (`gf_bitmatmul_stream`, the
contraction split over stream_groups(k) lanes per column strip); the
tile is the kernels' launch parameter: bytes of each row per thread
block, so the grid is ceil(per_chunk / tile) blocks.

Same flags and rows as the JAX tool: K=8, M=3 (the Cauchy code of the
write path), 4 MiB per chunk (256 KiB with --quick), one JSON line per
(variant, tile) with the keys stream, tile, exact, and gbps (input
bytes K * per_chunk over the time of one call) or error.  Every
configuration is checked bit-exactly against K1's plain version before
it is timed.  Timing: CUDA events around replays of a CUDA graph of
10 back-to-back calls, the median over 11 replays, per call — events
around a single call would measure the host's launch, not the kernel.

Deviation from the JAX tool: the exit code is 1 if any row has an
error or is not exact (the JAX tool only prints such rows).
`--device cpu` checks both variants through their plain versions
(256 KiB per chunk) and prints `exact` only, with no timing.

    python -m ceph_tpu_torch.tools.w32_sweep [--quick] [--tiles 65536,...]
        [--variants 0,1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import sys

import numpy as np
import torch

K, M = 8, 3
PER_CHUNK = 4 << 20           # resident bytes per chunk (divides all tiles)
QUICK_CHUNK = 1 << 18
TILES = [1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22]


def graph_ms(fn, calls: int = 10, samples: int = 11) -> float:
    """Median milliseconds of one call of `fn`: CUDA events around each
    replay of a CUDA graph holding `calls` back-to-back calls."""
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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="w32_sweep")
    ap.add_argument("--quick", action="store_true",
                    help="256 KiB per chunk (smoke)")
    ap.add_argument("--tiles", default=None,
                    help="comma-separated per-row tile bytes")
    ap.add_argument("--variants", default="0,1",
                    help="comma list: 0=all-planes (K1), 1=streaming (K4)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: plain versions, no timing")
    return ap.parse_args(argv)


def sweep(args) -> list[dict]:
    """The rows of one sweep, printed as they come."""
    from .. import resolve_device
    from ..ec import gf
    from ..ops import bitsliced as bs

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    tables = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(K, M)[K:]),
                              dev)
    rng = np.random.default_rng(7)
    per_chunk = PER_CHUNK if on_card and not args.quick else QUICK_CHUNK
    data = torch.from_numpy(
        rng.integers(0, 256, (K, per_chunk), dtype=np.uint8)).to(dev)
    want = bs.gf_bitmatmul_plain(tables, data)
    kernels = {False: bs.gf_bitmatmul, True: bs.gf_bitmatmul_stream}
    tiles = [int(t) for t in args.tiles.split(",")] if args.tiles else TILES
    rows = []
    for stream in (bool(int(v)) for v in args.variants.split(",")):
        for tile in tiles:
            if tile > per_chunk:
                continue
            rec = {"stream": stream, "tile": tile}
            try:
                fn = functools.partial(kernels[stream], tables, data,
                                       tile=tile)
                rec["exact"] = bool(torch.equal(fn(), want))
                if rec["exact"] and on_card:
                    rec["gbps"] = K * per_chunk / (graph_ms(fn) * 1e-3) / 1e9
            except (RuntimeError, ValueError) as e:
                rec["error"] = str(e)[:200]
            print(json.dumps(rec), flush=True)
            rows.append(rec)
    return rows


def main(argv=None) -> int:
    try:
        rows = sweep(parse_args(argv))
    except RuntimeError as e:           # no card, or the build failed
        print(f"w32_sweep: {e}", file=sys.stderr)
        return 1
    bad = [r for r in rows if "error" in r or not r.get("exact")]
    return 1 if bad or not rows else 0


if __name__ == "__main__":
    sys.exit(main())

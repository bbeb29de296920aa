"""K3's and K5's phase probe: where one launch of the fused parity +
per-run crc kernel (K3), or of the deep-scrub rows crc (K5), spends
its time, block by block.

    python -m ceph_tpu_torch.tools.k3_phases [--wb 512] [--runs 32]
        [--run-blocks 256]
    python -m ceph_tpu_torch.tools.k3_phases --ab DIR
    python -m ceph_tpu_torch.tools.k3_phases --kernel k5 [--shape chunk]
    python -m ceph_tpu_torch.tools.k3_phases --kernel k5 --ab DIR

Needs one CUDA card and nvcc.  Builds csrc/gf_encode_crc_acc.cu once
more with CTT_K3_PHASES into ceph_tpu_torch/build/ (thread 0 of every
thread block stamps clock64() and %globaltimer at the points its kernel
lists; the end gains one barrier so its stamp covers every warp),
checks that build exactly against K3's plain version, then launches it
at 8+3 on `--runs` runs of `--run-blocks` tiles of 4*wb bytes each (by
default the benchmark cell's call, 32 x 512 KiB), inputs warm in L2,
and prints one JSON line: the walk's shape (k3_walk) and grid, and
for each step the median and the largest SM cycles over the thread
blocks — the tables built and the run searched, the first tile staged
(both from the block's start), the first tile's parity and warp 0's
crcs of it, the steady state a tile (warp 0's crcs of the first tile
to those of the range's last, over the tiles between; blocks that walk
two or more), the range's flush (advance and atomics) and the block's
total — the cycles a nanosecond the stamps imply, the spread of the
blocks' starts and the span from the first start to the last end in
nanoseconds, and the graph-replay times (tools/w32_sweep.graph_ms) of
the probe build and of the kernel library's own K3 on the same inputs.

`--ab DIR` times K3 through `fused_hier_acc_call` at every K3_SHAPES
row in turns, DIR's tree, this one, this one, DIR's, as `--kernel k5
--ab` does K5's.

With `--kernel k5` the same build runs K5 on the rows of `--shape`
(K5_SHAPES: chip_smoke.py's three K5 rows), checked exactly against
K5's plain version.  Thread 0 of every thread block stamps clock64()
at its start, after the lane and nibble table builds, and after its
warp's first block is staged, its row searched, its chains and fold
done and its advance and atomic done (where the kernel's design does
those), and at its end after a barrier; %globaltimer at its start and
end.  The line gives each stamp's cycles from the block's start
(median and largest over the thread blocks), the block's total, the
cycles a nanosecond, the blocks' span and the graph-replay times of
the probe build and of the kernel library's K5 on the same inputs.

`--kernel k5 --ab DIR` times K5 through `crc32c_rows_l` at every
K5_SHAPES row in turns, DIR's tree, this one, this one, DIR's (each a
fresh process that builds its tree's kernels; DIR is a checkout of
another commit, e.g. the parent unpacked by `git archive`), each
checked exactly against its plain version, and prints one JSON line
of the medians (graph replays of 10 calls, 25 samples) per tree and
turn.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

K, M = 8, 3
PHASES = 9                   # stamps a block (csrc kPhases)
# K3's runs in tiles of 2 KiB: the benchmark cell's call (32 x 512 KiB),
# chip_smoke.py's two K3 rows (one 512 KiB run; 512 KiB + 300 KiB + 777
# B front-padded), and a run longer than a range
K3_SHAPES = {
    "cell": [256] * 32,
    "one": [256],
    "two": [256, 151],
    "long": [2000, 7],
}
K5_BLOCK = 2048              # the scrub block (crc32c_linear.SCRUB_BLOCK)
# K5's rows in blocks: one 64 MiB scrub chunk of 4 MiB objects (132 x
# 512 KiB); a chunk of mixed rows (66 x 1 MiB as phase I's, 11 x 600 KiB,
# 3 empty, 11 of one block); and an edge chunk whose rows cross the
# warps' ranges, with rows of one block and empty rows between them
K5_SHAPES = {
    "chunk": [256] * 132,
    "mixed": [512] * 66 + [300] * 11 + [0, 0, 0] + [1] * 11,
    "edge": [1, 0, 7, 1, 0, 0, 13, 1] * 64 + [4099],
}


def build_probe() -> ctypes.CDLL:
    from ..ops import _build
    out = _build.BUILD_DIR / f"libk3_phases.{_build.source_hash()}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS,
               "-DCTT_K3_PHASES", "-shared", "-I", str(_build.CSRC),
               "-o", str(out), str(_build.CSRC / "gf_encode_crc_acc.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n$ {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ctt_gf_encode_crc_acc.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32,
                                          i32, i64, i32, i32, vp]
    lib.ctt_gf_encode_crc_acc.restype = i32
    lib.ctt_crc32c_rows.argtypes = [vp, vp, vp, vp, i32, i64, i32, i32, vp]
    lib.ctt_crc32c_rows.restype = i32
    lib.ctt_k3_set_phase_buffer.argtypes = [vp]
    lib.ctt_k3_set_phase_buffer.restype = i32
    return lib


def probe(wb: int = 512, runs: int = 32, run_blocks: int = 256,
          seed: int = 6) -> dict:
    from ..ec import gf
    from ..ops import bitsliced as bs
    from .w32_sweep import graph_ms
    dev = torch.device("cuda")
    block = 4 * wb
    ntiles = runs * run_blocks
    n = block * ntiles
    rng = np.random.default_rng(seed)
    tab = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(K, M)[K:]),
                           dev)
    data = torch.from_numpy(rng.integers(0, 256, (K, n), dtype=np.uint8)) \
        .to(dev)
    _staged, ends = bs._acc_launch_args([run_blocks] * runs, dev)
    ops = bs._k3_ops_tensor(block, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = bs.k3_launch(n, block, K, M, sms)
    tiles = np.array([b - a for a, b in bs.k3_ranges(ntiles, grid)])
    stamps = torch.zeros((grid, PHASES), dtype=torch.int64, device=dev)
    lib = build_probe()
    if lib.ctt_k3_set_phase_buffer(stamps.data_ptr()) != 0:
        raise RuntimeError("could not set the probe's buffer")
    parity = torch.empty((M, n), dtype=torch.uint8, device=dev)
    lacc = torch.zeros((runs, K + M), dtype=torch.int64, device=dev)

    def launch():
        lacc.zero_()
        rc = lib.ctt_gf_encode_crc_acc(
            tab.data_ptr(), data.data_ptr(), parity.data_ptr(),
            lacc.data_ptr(), ops.data_ptr(), ends.data_ptr(), runs, M, K, n,
            block, bs.K3_DIGITS, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")
    launch()
    torch.cuda.synchronize()
    want = bs.fused_hier_acc_call_plain(tab, data, ends, wb)
    if not (torch.equal(parity, want[0]) and torch.equal(lacc, want[1])):
        raise AssertionError("the probe build differs from K3's plain version")
    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    s = stamps.cpu().numpy().astype(np.int64)
    multi = tiles >= 2
    cyc = {"tables_and_search": s[:, 1] - s[:, 0],
           "first_tile_staged": s[:, 2] - s[:, 0],
           "first_parity": s[:, 3] - s[:, 2],
           "first_crc": s[:, 4] - s[:, 3],
           "flush": s[:, 8] - s[:, 5],
           "block_total": s[:, 8] - s[:, 0]}
    if multi.any():
        cyc["steady_per_tile"] = ((s[multi, 5] - s[multi, 4])
                                  / (tiles[multi] - 1))
    ns = s[:, 7] - s[:, 6]
    rate = float(np.median(cyc["block_total"] / np.maximum(ns, 1)))
    probe_us = graph_ms(launch, calls=10, samples=25) * 1e3
    lib_us = graph_ms(lambda: bs.fused_hier_acc_call(tab, data, ends, wb),
                      calls=10, samples=25) * 1e3
    return {"device": torch.cuda.get_device_name(dev), "k": K, "m": M,
            "block": block, "runs": runs, "run_blocks": run_blocks,
            "walk": bs.k3_walk(M, K, block)._asdict(), "grid": grid,
            "tiles_a_range": {"min": int(tiles.min()),
                              "max": int(tiles.max())},
            "cycles": {k: {"median": float(np.median(v)),
                           "max": float(v.max())}
                       for k, v in cyc.items()},
            "cycles_per_ns": rate,
            "starts_spread_ns": int(s[:, 6].max() - s[:, 6].min()),
            "first_start_to_last_end_ns": int(s[:, 7].max() - s[:, 6].min()),
            "probe_launch_us": probe_us, "k3_wrapper_us": lib_us}


def _rows_inputs(counts, dev, seed: int):
    rng = np.random.default_rng(seed)
    n = sum(counts) * K5_BLOCK
    data = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int64, device=dev)
    return data, ends


def probe_k5(shape: str = "chunk", seed: int = 11) -> dict:
    from ..ops import bitsliced as bs
    from .w32_sweep import graph_ms
    dev = torch.device("cuda")
    counts = K5_SHAPES[shape]
    data, ends = _rows_inputs(counts, dev, seed)
    nrows, nblocks = len(counts), sum(counts)
    ops = bs._k3_ops_tensor(K5_BLOCK, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # more rows than any grid has thread blocks; the unused stay zero
    stamps = torch.zeros((8 * sms, PHASES), dtype=torch.int64, device=dev)
    lib = build_probe()
    if lib.ctt_k3_set_phase_buffer(stamps.data_ptr()) != 0:
        raise RuntimeError("could not set the probe's buffer")
    lout = torch.zeros(nrows, dtype=torch.int64, device=dev)

    def launch():
        lout.zero_()
        rc = lib.ctt_crc32c_rows(
            data.data_ptr(), lout.data_ptr(), ops.data_ptr(),
            ends.data_ptr(), nrows, nblocks, K5_BLOCK, bs.K3_DIGITS,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")
    launch()
    torch.cuda.synchronize()
    if not torch.equal(lout, bs.crc32c_rows_l_plain(data, ends, K5_BLOCK)):
        raise AssertionError("the probe build differs from K5's plain version")
    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    s = stamps.cpu().numpy().astype(np.int64)
    s = s[s[:, 6] != 0]
    steps = {1: "tables", 2: "first_block_staged", 3: "row_searched",
             4: "first_chains_fold", 5: "advance_atomic", 8: "block_end"}
    cyc = {}
    for i, name in steps.items():
        v = s[s[:, i] != 0][:, i] - s[s[:, i] != 0][:, 0]
        if v.size:
            cyc[name] = {"median": float(np.median(v)), "max": int(v.max())}
    ns = s[:, 7] - s[:, 6]
    rate = float(np.median((s[:, 8] - s[:, 0]) / np.maximum(ns, 1)))
    probe_us = graph_ms(launch, calls=10, samples=25) * 1e3
    lib_us = graph_ms(lambda: bs.crc32c_rows_l(data, ends, K5_BLOCK),
                      calls=10, samples=25) * 1e3
    return {"device": torch.cuda.get_device_name(dev), "kernel": "k5",
            "shape": shape, "rows": nrows, "blocks": nblocks,
            "grid": int(s.shape[0]),
            "cycles_from_start": cyc, "cycles_per_ns": rate,
            "block_ns": {"median": float(np.median(ns)), "max": int(ns.max())},
            "starts_spread_ns": int(s[:, 6].max() - s[:, 6].min()),
            "first_start_to_last_end_ns": int(s[:, 7].max() - s[:, 6].min()),
            "probe_launch_us": probe_us, "k5_wrapper_us": lib_us}


# Run in a fresh process on a tree given as argv[1] (the shapes as JSON
# in argv[2]): only what every tree with K5 has, crc32c_rows_l, its plain
# version and w32_sweep.graph_ms; _AB_TIMER_K3 likewise K3's wrapper.
_AB_TIMER = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from ceph_tpu_torch.ops import bitsliced as bs
from ceph_tpu_torch.tools.w32_sweep import graph_ms
dev = torch.device("cuda")
out = {}
for name, counts in json.loads(sys.argv[2]).items():
    rng = np.random.default_rng(len(counts))
    data = torch.from_numpy(rng.integers(0, 256, sum(counts) * 2048,
                                         dtype=np.uint8)).to(dev)
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int64, device=dev)
    got = bs.crc32c_rows_l(data, ends)
    if not torch.equal(got, bs.crc32c_rows_l_plain(data, ends)):
        raise SystemExit(f"K5 differs from its plain version at {name}")
    out[name] = graph_ms(lambda: bs.crc32c_rows_l(data, ends), calls=10,
                         samples=25) * 1e3
print(json.dumps(out))
"""


_AB_TIMER_K3 = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ops import bitsliced as bs
from ceph_tpu_torch.tools.w32_sweep import graph_ms
dev = torch.device("cuda")
tab = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(8, 3)[8:]), dev)
out = {}
for name, counts in json.loads(sys.argv[2]).items():
    rng = np.random.default_rng(len(counts))
    data = torch.from_numpy(rng.integers(0, 256, (8, sum(counts) * 2048),
                                         dtype=np.uint8)).to(dev)
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int64, device=dev)
    got = bs.fused_hier_acc_call(tab, data, ends, 512)
    want = bs.fused_hier_acc_call_plain(tab, data, ends, 512)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"K3 differs from its plain version at {name}")
    out[name] = graph_ms(lambda: bs.fused_hier_acc_call(tab, data, ends,
                                                        512),
                         calls=10, samples=25) * 1e3
print(json.dumps(out))
"""


def ab(kernel: str, other: str) -> dict:
    """K3's (K3_SHAPES) or K5's (K5_SHAPES) graph-replay times on
    `other`'s tree and this one, in turns other, this, this, other."""
    import os
    import subprocess
    from pathlib import Path
    here = str(Path(__file__).resolve().parents[2])
    other = str(Path(other).resolve())
    turns = []
    timer, shapes = (_AB_TIMER_K3, K3_SHAPES) if kernel == "k3" else \
        (_AB_TIMER, K5_SHAPES)
    for tree in (other, here, here, other):
        env = dict(os.environ, PYTHONPATH=tree)
        res = subprocess.run(
            [sys.executable, "-c", timer, tree, json.dumps(shapes)],
            capture_output=True, text=True, env=env, cwd=tree, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"{kernel} timing on {tree} failed:\n"
                               f"{res.stderr}")
        turns.append({"tree": "other" if tree == other else "this",
                      "us": json.loads(res.stdout.strip().splitlines()[-1])})
    return {"device": torch.cuda.get_device_name(0), "kernel": kernel,
            "other": other, "turns": turns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="k3_phases")
    ap.add_argument("--kernel", choices=("k3", "k5"), default="k3")
    ap.add_argument("--wb", type=int, default=512)
    ap.add_argument("--runs", type=int, default=32)
    ap.add_argument("--run-blocks", type=int, default=256)
    ap.add_argument("--shape", choices=sorted(K5_SHAPES), default="chunk")
    ap.add_argument("--ab", metavar="DIR",
                    help="time the kernel on DIR's tree and this one in "
                         "turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 1
    if args.ab:
        out = ab(args.kernel, args.ab)
    elif args.kernel == "k5":
        out = probe_k5(args.shape)
    else:
        out = probe(args.wb, args.runs, args.run_blocks)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K3's phase probe: where one launch of the fused parity + per-run crc
kernel spends its time, block by block.

    python -m ceph_tpu_torch.tools.k3_phases [--wb 512] [--run-blocks 256]

Needs one CUDA card and nvcc.  Builds csrc/gf_encode_crc_acc.cu once
more with CTT_K3_PHASES into ceph_tpu_torch/build/ (thread 0 of every
thread block stamps clock64() at its start and after each block-wide
step of its first tile, and %globaltimer at its start and end; the crc
step gains one barrier so its stamp covers every warp), checks that
build exactly against K3's plain version, then launches it at 8+3 on
one run of `--run-blocks` blocks of 4*wb bytes, inputs warm in L2, and
prints one JSON line: for each step the median and the largest SM
cycles over the thread blocks — tables + staging (the start to the
first barrier; thread 0's own share of the table builds apart),
parity, crc + fold + advance + atomics (warp 0's first row to its
fold apart) — the cycles a
nanosecond the stamps imply, the spread of the blocks' starts and the
span from the first start to the last end in nanoseconds, and the
graph-replay times (tools/w32_sweep.graph_ms) of the probe build and of
the kernel library's own K3 on the same inputs.  Exits 1 without a
card.
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
PHASES = 8                   # stamps a block (csrc kPhases)


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
    lib.ctt_k3_set_phase_buffer.argtypes = [vp]
    lib.ctt_k3_set_phase_buffer.restype = i32
    return lib


def probe(wb: int = 512, run_blocks: int = 256, seed: int = 6) -> dict:
    from ..ec import gf
    from ..ops import bitsliced as bs
    from .w32_sweep import graph_ms
    dev = torch.device("cuda")
    block = 4 * wb
    n = block * run_blocks
    rng = np.random.default_rng(seed)
    tab = bs.tables_tensor(gf.product_tables(gf.cauchy_rs_matrix(K, M)[K:]),
                           dev)
    data = torch.from_numpy(rng.integers(0, 256, (K, n), dtype=np.uint8)) \
        .to(dev)
    _staged, ends = bs._acc_launch_args([run_blocks], dev)
    ops = bs._k3_ops_tensor(block, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = bs.k3_launch(n, block, K, M, sms)
    stamps = torch.zeros((grid, PHASES), dtype=torch.int64, device=dev)
    lib = build_probe()
    if lib.ctt_k3_set_phase_buffer(stamps.data_ptr()) != 0:
        raise RuntimeError("could not set the probe's buffer")
    parity = torch.empty((M, n), dtype=torch.uint8, device=dev)
    lacc = torch.zeros((1, K + M), dtype=torch.int64, device=dev)

    def launch():
        lacc.zero_()
        rc = lib.ctt_gf_encode_crc_acc(
            tab.data_ptr(), data.data_ptr(), parity.data_ptr(),
            lacc.data_ptr(), ops.data_ptr(), ends.data_ptr(), 1, M, K, n,
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
    cyc = {"tables_and_staging": s[:, 1] - s[:, 0],
           "thread0_tables": s[:, 4] - s[:, 0],
           "parity": s[:, 2] - s[:, 1],
           "crc_fold_advance": s[:, 3] - s[:, 2],
           "warp0_row0_crc_fold": s[:, 5] - s[:, 2],
           "block_total": s[:, 3] - s[:, 0]}
    ns = s[:, 7] - s[:, 6]
    rate = float(np.median(cyc["block_total"] / np.maximum(ns, 1)))
    probe_us = graph_ms(launch, calls=10, samples=25) * 1e3
    lib_us = graph_ms(lambda: bs.fused_hier_acc_call(tab, data, ends, wb),
                      calls=10, samples=25) * 1e3
    return {"device": torch.cuda.get_device_name(dev), "k": K, "m": M,
            "block": block, "run_blocks": run_blocks, "grid": grid,
            "cycles": {k: {"median": float(np.median(v)), "max": int(v.max())}
                       for k, v in cyc.items()},
            "cycles_per_ns": rate,
            "starts_spread_ns": int(s[:, 6].max() - s[:, 6].min()),
            "first_start_to_last_end_ns": int(s[:, 7].max() - s[:, 6].min()),
            "probe_launch_us": probe_us, "k3_wrapper_us": lib_us}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="k3_phases")
    ap.add_argument("--wb", type=int, default=512)
    ap.add_argument("--run-blocks", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(probe(args.wb, args.run_blocks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

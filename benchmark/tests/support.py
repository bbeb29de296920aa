"""Small cells for the benchmark's CPU tests: a copy of the checkout's
BENCHMARK.json and data files in a temporary root, with cells added
from new files alone."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

# one small cell a configuration and entry: shards of 4 KiB (two K3
# blocks; 64 CLAY planes of 64 bytes)
SMALL = {
    "tiny-encode": ("ec-k8m3-4m", 32768,
                    {"entry": "encode", "objects_per_call": 4,
                     "pool_batches": 2}),
    "tiny-repair": ("ec-k8m3-4m", 32768,
                    {"entry": "repair", "objects_per_call": 4,
                     "pool_batches": 1}),
    "tiny-clay": ("ec-clay-k8m4d11-4m", 32768,
                  {"entry": "clay_repair", "objects_per_call": 4,
                   "pool_batches": 1}),
    # Open question 1's source: pageable host memory through the queue
    "tiny-host": ("ec-k8m3-4m", 32768,
                  {"entry": "encode", "source": "host",
                   "objects_per_call": 8, "pool_batches": 2, "owners": 4,
                   "window_us": 2000, "max_bytes": 65536}),
}
ON_CARD = ("tiny-encode", "tiny-repair", "tiny-clay")


def make_root(tmp: Path, cells=tuple(SMALL)) -> Path:
    """A root holding BENCHMARK.json and benchmark/'s data files, plus
    each of `cells` (names of SMALL) as a new config, traffic and
    workload."""
    root = Path(tmp) / "root"
    for sub in ("configs", "traffic", "metrics", "entries"):
        shutil.copytree(REPO / "benchmark" / sub, root / "benchmark" / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in cells:
        base, obj, over = SMALL[name]
        cfg = json.loads((REPO / "benchmark" / "configs"
                          / f"{base}.json").read_text())
        cfg.update(name=f"{name}-cfg", object_bytes=obj,
                   shard_bytes=obj // cfg["k"])
        cfg_file = f"benchmark/configs/{name}-cfg.json"
        (root / cfg_file).write_text(json.dumps(cfg))
        traffic = {"source": "device", "object_bytes": obj, "in_flight": 2,
                   "erasures": 1, "lost": "random", **over}
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
        bench["configs"].append({"name": f"{name}-cfg", "source": "test",
                                 "file": cfg_file, "reduced": [],
                                 "why": "test"})
        bench["workloads"].append({"name": name, "config": f"{name}-cfg",
                                   "traffic": name, "chips": 1,
                                   "why": "test"})
        metric = "encode_GBps" if over["entry"] == "encode" \
            else "repair_GBps"
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m.get("moves", m["name"]) == metric and "workloads" in m:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_small(root: Path, cell: str, seed: int = 5, seconds: float = 0.4,
              trace: bool = False, control: bool = False) -> dict:
    from benchmark.harness import runner
    return runner.run_cell(root, cell, seed, seconds, trace,
                           torch.device("cpu"), time.time(),
                           log=lambda s: None, control=control)

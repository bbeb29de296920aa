"""What every timed entry shares, and the loader that finds a cell's
entry by the names in its traffic file.

A traffic file names its entry (`entry`) and where the entry's inputs
live (`source`, `device` by default); the entry is the `ENTRY` class of
`benchmark/entries/<entry>_<source>.py`.  So a later cell with another
entry adds a file there and edits none.  An entry is set up from the
seed, warmed on every shape the cell's calls use, called in the window,
and checked after it against the reference, which works out again
whatever the program derived (generator, recovery matrices, layouts)
from the configuration's `field_polynomial` and `technique`.  With
`control` set, the reference computed in another field
(`gf256.control_poly`) takes the program's place in the window.
"""

from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import gf256
from . import cells

SEED_MASK = (1 << 63) - 1
LOST_DRAWS = 1 << 16
PART = re.compile(r"[a-z][a-z0-9_]*")


class Done:
    """Completion of a call whose work ran synchronously (the CPU)."""

    def synchronize(self) -> None:
        pass


def codec(cfg: dict, device: torch.device):
    """The program's codec for a configuration, from its plugin registry."""
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
    prof = {key: str(val) for key, val in cfg["profile"].items()}
    if cfg["plugin"] == "torch":
        prof["device"] = str(device)
    return ErasureCodePluginRegistry.instance().factory(cfg["plugin"], prof)


def lost_choices(traffic: dict, n: int) -> list[int]:
    """The shards a repair cell's calls may lose: all n, or a list."""
    if int(traffic.get("erasures", 1)) != 1:
        raise ValueError("the repair entries rebuild one lost shard a call")
    if int(traffic.get("pool_batches", 1)) != 1:
        raise ValueError("the repair entries hold one batch of objects, "
                         "its survivors for every lost shard")
    lost = traffic.get("lost", "random")
    return list(range(n)) if lost == "random" else [int(x) for x in lost]


class Entry:
    """One cell's timed call: set up from the seed, warmed, called in
    the window, checked after it."""

    metric = ""

    def __init__(self, cfg: dict, traffic: dict, device: torch.device,
                 seed: int, control: bool = False):
        self.cfg = cfg
        self.tr = traffic
        self.device = device
        self.control = control
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed & SEED_MASK)
        self.k = int(cfg["k"])
        self.m = int(cfg["m"])
        self.poly = gf256.poly_of(cfg)
        self.ctl_poly = gf256.control_poly(self.poly)
        self.technique = gf256.technique_of(cfg)
        self.objects = int(traffic["objects_per_call"])
        self.object_bytes = int(traffic["object_bytes"])
        if self.object_bytes != int(cfg["object_bytes"]):
            raise ValueError(f"traffic objects of {self.object_bytes} bytes "
                             f"on a configuration of {cfg['object_bytes']}")
        self.shard = self.object_bytes // self.k
        self.info: dict = {}
        self.reference_s = 0.0

    def _random(self, *shape) -> torch.Tensor:
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=self.device, generator=self.gen)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def by_reference(self):
        """Set-up work of the reference (encoding the inputs a repair
        starts from): its seconds go to `reference_s`, which setup_s
        leaves out."""
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.reference_s += time.perf_counter() - t0

    def completion(self, out):
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return Done()

    def finish(self, out):
        """The call's output once its completion has been seen."""
        return out

    def free_inputs(self) -> None:
        """Drop what only the window needs, before the comparison."""

    def close(self) -> None:
        pass


def entry_path(root: Path, traffic: dict) -> Path:
    entry, source = traffic["entry"], traffic.get("source", "device")
    for part in (entry, source):
        if not PART.fullmatch(str(part)):
            raise ValueError(f"an entry and a source are lower-case names: "
                             f"{part!r}")
    return Path(root) / cells.BENCH_DIR / "entries" / f"{entry}_{source}.py"


def build(root: Path, cfg: dict, traffic: dict, device: torch.device,
          seed: int, control: bool = False) -> Entry:
    path = entry_path(root, traffic)
    if not path.exists():
        raise ValueError(f"no entry {traffic['entry']!r} with inputs on "
                         f"{traffic.get('source', 'device')!r} ({path})")
    entry = cells.load_module(path, "benchmark_entry_").ENTRY(
        cfg, traffic, device, seed, control)
    entry.setup()
    return entry

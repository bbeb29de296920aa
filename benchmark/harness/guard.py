"""What a run may not load, and where its caches go.

The benchmark measures the PyTorch and CUDA package alone: a run whose
process holds JAX, its libraries or the JAX package fails.  Modules
are compared by their whole top-level name, so `ceph_tpu_torch` passes
and `ceph_tpu` does not.

Every cache sits at a fixed path under `benchmark/.cache` in the
checkout, so only a checkout's first run fills it: the autotuner's
point, Triton's and torch extensions' builds, and Python's compiled
bytecode.  An installation that ships no bytecode and forbids writing
it (PYTHONDONTWRITEBYTECODE) compiles torch's 2,000 modules again in
every process, which was most of set-up and of its spread.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ceph_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)


def cache_env(bench_dir: Path) -> dict[str, str]:
    """The environment of a run: no operating-point sweep, and every
    cache at a fixed path inside the checkout."""
    cache = Path(bench_dir).resolve() / ".cache"
    return {"CEPH_TPU_AUTOTUNE": "0",
            "CEPH_TPU_AUTOTUNE_CACHE": str(cache / "autotune.json"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def apply_env(bench_dir: Path) -> None:
    """Set the run's environment, and keep the bytecode of every module
    imported from here on in the checkout's cache: call it before
    anything imports torch or numpy."""
    os.environ.update(cache_env(bench_dir))
    sys.pycache_prefix = str(Path(bench_dir).resolve() / ".cache" / "pycache")
    sys.dont_write_bytecode = False

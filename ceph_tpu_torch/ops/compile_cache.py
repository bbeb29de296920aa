"""The kernel library cache: one nvcc build per source hash, per host.

The port of ceph_tpu/ops/compile_cache.py.  On the TPU every jit
bucket (a kind, path and padded shape) compiled an XLA/Mosaic program
at its first launch, and the reference kept those programs in JAX's
persistent compilation cache so a restarted daemon re-traced but never
re-compiled.  What "compile" means on the card:

* one nvcc build per source hash: every kernel of csrc/ goes into one
  shared library (ops/_build.py), named by the hash of the sources and
  flags.  This module points the library's directory somewhere that
  outlives the process, so a restarted daemon loads the library and
  runs no nvcc;
* the CUDA context, created at the process's first use of the card;
* each kernel function's lazy module load at its first launch;
* no per-shape program: a kernel takes any width, so nothing compiles
  for a new bucket.

The last three happen in every process and no file can keep them; the
boot prewarm (ops/prewarm.py) is what takes them off the runtime path.

`enable()` must run before the first `_build.load()`: once a library is
loaded from one directory it cannot move, and enabling another leaves
the cache disabled with `error` set.  An unwritable directory does the
same; neither falls back to another directory.  `hit_count()` counts
loads of an already-built library (no nvcc run in this process); a load
that ran nvcc is a compile, counted by `_build.build_count()`.  The
flight recorder (ops/profiler.py) attributes a first-seen bucket from
those counts.

The directory: `cache_dir` (conf osd_ec_compile_cache_dir), else
$CEPH_TPU_TORCH_COMPILE_CACHE, else ceph_tpu_torch/build/ (listed in
.gitignore), where the library goes without this module too.
"""

from __future__ import annotations

import contextlib
import os
import threading
from pathlib import Path

from . import _build

ENV = "CEPH_TPU_TORCH_COMPILE_CACHE"

_lock = threading.Lock()
_enabled = False
_dir: str | None = None
_error: str | None = None


def default_cache_dir() -> Path:
    """$CEPH_TPU_TORCH_COMPILE_CACHE, else the package's build
    directory."""
    env = os.environ.get(ENV)
    return Path(env) if env else _build.DEFAULT_BUILD_DIR


def enable(cache_dir: str | os.PathLike | None = None) -> bool:
    """Point the kernel library's directory at `cache_dir` (default:
    default_cache_dir()).  Idempotent per process — the first caller's
    directory wins (one cache per host, like the mesh shape); returns
    whether the cache is live."""
    global _enabled, _dir, _error
    with _lock:
        if _enabled:
            return True
        path = Path(cache_dir) if cache_dir else default_cache_dir()
        try:
            path.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            _error = f"mkdir {path}: {e}"
            return False
        if not os.access(path, os.W_OK | os.X_OK):
            _error = f"{path} is not writable"
            return False
        try:
            _build.set_build_dir(path)
        except RuntimeError as e:
            _error = str(e)
            return False
        _enabled = True
        _dir = str(path)
        _error = None
        return True


def enabled() -> bool:
    return _enabled


def cache_dir() -> str | None:
    return _dir


def hit_count() -> int:
    """Loads of an already-built kernel library in this process."""
    return _build.hit_count()


def status() -> dict:
    """The `prewarm status` / `compile ledger` block: the directory,
    the libraries it holds (one per source hash) and the build state of
    this process's library."""
    out = {
        "enabled": _enabled,
        "dir": _dir,
        "hits": hit_count(),
        "kernel_library": _build.status(),
    }
    if _error:
        out["error"] = _error
    if _enabled and _dir:
        try:
            libs = [f for f in Path(_dir).glob(_build.LIBRARY_GLOB)
                    if f.is_file()]
            out["entries"] = len(libs)
            out["bytes"] = sum(f.stat().st_size for f in libs)
        except OSError:
            pass
    return out


def reset_for_tests() -> None:
    """Tests only: forget the enabled state and, when no library is
    loaded yet, point the build back at the package's directory."""
    global _enabled, _dir, _error
    with _lock:
        _enabled = False
        _dir = None
        _error = None
        with contextlib.suppress(RuntimeError):
            _build.set_build_dir(_build.DEFAULT_BUILD_DIR)

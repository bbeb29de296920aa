"""Build and bind the CUDA kernels of `ceph_tpu_torch/csrc/`.

At first use the sources are compiled with nvcc for `sm_90a` into one
shared library with a plain C interface, which is loaded with ctypes
(no PyTorch headers, so a build takes seconds).  Each `.cu` compiles
to an object in its own nvcc process, all started together, and one
more nvcc links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu -o <build>/<name>.o
    nvcc -shared -o <build>/libceph_tpu_torch_kernels.<hash>.so *.o

The library lands in `ceph_tpu_torch/build/` (listed in .gitignore),
named by a hash of the sources and flags, so a source change rebuilds
and an unchanged tree reuses the last build.  Nothing here runs at
import: `load()` is called by the kernel wrappers on their first
launch.  A failed build raises; there is no fallback.  `status()` says
whether this process compiled the library or loaded it from the build
directory (the flight recorder's compile attribution, ops/profiler.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# nvcc builds run by this process, and their wall seconds
_builds = {"count": 0, "seconds": 0.0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of ceph_tpu_torch "
                       "are built with the CUDA toolkit at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libceph_tpu_torch_kernels.{source_hash()}.so"


def build() -> Path:
    """Compile the kernels if the library for this source hash is
    missing; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC),
                   "-c", str(src), "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
               *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp_lib, out)    # atomic: concurrent builds agree
    _builds["count"] += 1
    _builds["seconds"] += time.perf_counter() - t0
    return out


def build_count() -> int:
    """nvcc builds this process has run (0 when every library it loaded
    was already in the build directory)."""
    return _builds["count"]


def status() -> dict:
    """The kernel library's provenance: its path, whether it is loaded,
    and the nvcc builds this process ran for it."""
    return {"library": library_path().name, "loaded": _lib is not None,
            "builds_in_process": _builds["count"],
            "build_s": round(_builds["seconds"], 3)}


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, binding the C
    entry points with explicit argument types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ctt_gf_bitmatmul.argtypes = [vp, vp, vp, i32, i32, i64, i64,
                                         i32, i64, i32, vp]
        lib.ctt_gf_bitmatmul.restype = i32
        lib.ctt_gf_bitmatmul_stream.argtypes = [vp, vp, vp, i32, i32, i64,
                                                i64, i32, i32, i32, i64, vp]
        lib.ctt_gf_bitmatmul_stream.restype = i32
        lib.ctt_gf_encode_crc.argtypes = [vp, vp, vp, vp, vp, i32, i32,
                                          i64, i32, vp]
        lib.ctt_gf_encode_crc.restype = i32
        lib.ctt_gf_encode_crc_acc.argtypes = [vp, vp, vp, vp, vp, vp, i32,
                                              i32, i32, i64, i32, i32, vp]
        lib.ctt_gf_encode_crc_acc.restype = i32
        _lib = lib
        return lib

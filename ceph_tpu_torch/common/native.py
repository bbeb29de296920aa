"""ctypes bindings of the native CPU data-plane library (native/).

The CPU erasure-code plugins (ec/plugins/ec_isa.py, ec_jerasure.py) get
their GF(2^8) region multiply from the C sources `native/gf8.c` and
`native/crc32c.c`, the role of the reference's ISA-L / gf-complete
SIMD kernels, and common/crc32c.py its host crc32c (SSE4.2 or
slice-by-8), zero advance and combine.  At first use the sources are
compiled with `cc`, with the flags of `native/Makefile`, into one
shared library under `ceph_tpu_torch/build/` (listed in .gitignore),
named by a hash of the sources and flags; `native/` itself is only
read.

When no C compiler is there or the build fails, `gf8_matvec` returns
None and gf.gf_matvec runs its numpy table path, and common/crc32c.py
its numpy tables; both give the same bytes (the role of the
reference's table fallback).  This is a host library, not a device
kernel; `available()` says which implementation runs, so a
measurement can require the native one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("crc32c.c", "gf8.c")
CFLAGS = ["-O3", "-fPIC", "-Wall", "-Wextra", "-std=c11"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libceph_tpu_native.{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if the one for this source hash is missing;
    returns its path.  Raises when the compiler fails."""
    out = library_path()
    if out.exists():
        return out
    cc = os.environ.get("CC") or shutil.which("cc")
    if not cc:
        raise RuntimeError("no C compiler (cc) to build the native library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = Path(tmp) / out.name
        cmd = [cc, *CFLAGS, "-shared", "-o", str(tmp_lib),
               *(str(NATIVE_DIR / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"cc failed:\n$ {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp_lib, out)    # atomic: concurrent builds agree
    return out


def load() -> ctypes.CDLL | None:
    """Build (if needed) and load the library; None if it cannot be
    built, in which case the callers run their numpy paths."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        lib.ceph_tpu_crc32c.restype = ctypes.c_uint32
        lib.ceph_tpu_crc32c.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
        lib.ceph_tpu_crc32c_zeros.restype = ctypes.c_uint32
        lib.ceph_tpu_crc32c_zeros.argtypes = [ctypes.c_uint32,
                                              ctypes.c_uint64]
        lib.ceph_tpu_crc32c_combine.restype = ctypes.c_uint32
        lib.ceph_tpu_crc32c_combine.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
        lib.gf8_init.restype = None
        lib.gf8_init.argtypes = []
        lib.gf8_encode.restype = None
        lib.gf8_encode.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_size_t]
        lib.gf8_init()
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return load() is not None


def gf8_matvec(mat, chunks) -> np.ndarray | None:
    """Native GF(2^8) matrix x chunks product: (r, k) x (k, n) -> (r, n)
    uint8, or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    r, k = mat.shape
    n = chunks.shape[1]
    out = np.empty((r, n), dtype=np.uint8)
    data_ptrs = (ctypes.c_void_p * k)(
        *[chunks[j].ctypes.data for j in range(k)])
    par_ptrs = (ctypes.c_void_p * r)(
        *[out[i].ctypes.data for i in range(r)])
    lib.gf8_encode(k, r, mat.ctypes.data, data_ptrs, par_ptrs, n)
    return out

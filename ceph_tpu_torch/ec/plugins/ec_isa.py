"""CPU RS plugin with cached decode tables ("isa" role).

The port of ceph_tpu/ec/plugins/ec_isa.py, filling the role of the
reference's ISA-L plugin (src/erasure-code/isa/ErasureCodeIsa.{h,cc}):
Vandermonde or Cauchy matrices, an LRU cache of decode matrices keyed by
the erasure signature (reference ErasureCodeIsaTableCache.{h,cc}, "good
up to (12,4)"), and a pure-XOR fast path when exactly one data chunk is
lost and its decode row is all ones (reference xor_op.h:74 region_xor).

The region work is gf.gf_matvec: the native SIMD library (common/native)
for widths of 1 KiB and more, the numpy tables below that or when the
library cannot be built.  With the native library this is the CPU-best
side of `ec_benchmark --ab`.
"""

from __future__ import annotations

import errno
import threading
from collections import OrderedDict

import numpy as np

from .. import gf
from ..base import ErasureCode
from ..interface import ErasureCodeError, Profile
from ..registry import ErasureCodePlugin, ErasureCodePluginRegistry

__erasure_code_version__ = ErasureCodePlugin.abi_version


class DecodeTableCache:
    """LRU cache of inverted decode matrices keyed by (k, m, technique,
    survivors, targets), with hit and miss counts.

    Reference: ErasureCodeIsaTableCache caches `ec_init_tables` outputs per
    erasure signature so repeated degraded reads skip the inversion.
    """

    def __init__(self, capacity: int = 2516):  # reference cache ~ (12,4) space
        self.capacity = capacity
        self.lock = threading.Lock()
        self._cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple) -> np.ndarray | None:
        with self.lock:
            m = self._cache.get(key)
            if m is not None:
                self.hits += 1
                self._cache.move_to_end(key)
            else:
                self.misses += 1
            return m

    def put(self, key: tuple, mat: np.ndarray) -> None:
        with self.lock:
            self._cache[key] = mat
            self._cache.move_to_end(key)
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)


_TABLE_CACHE = DecodeTableCache()


class ErasureCodeIsa(ErasureCode):
    technique = "reed_sol_van"

    def __init__(self, technique: str = "reed_sol_van"):
        super().__init__()
        self.technique = technique
        self.matrix: np.ndarray | None = None

    def init(self, profile: Profile) -> None:
        self.k = profile.to_int("k", 7)
        self.m = profile.to_int("m", 3)
        if self.k < 1 or self.m < 1 or self.k + self.m > gf.GF_SIZE:
            raise ErasureCodeError(errno.EINVAL, f"bad k={self.k} m={self.m}")
        if self.technique == "cauchy":
            self.matrix = gf.cauchy_rs_matrix(self.k, self.m)
        else:
            self.matrix = gf.vandermonde_rs_matrix(self.k, self.m)
        super().init(profile)

    def encode_chunks(self, chunks: np.ndarray) -> np.ndarray:
        return gf.gf_matvec(self.matrix[self.k:], chunks)

    def decode_chunks(self, dense: np.ndarray, erasures) -> np.ndarray:
        n = self.get_chunk_count()
        erased = sorted(set(erasures))
        survivors = [i for i in range(n) if i not in set(erased)][: self.k]
        if len(survivors) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough survivors")
        out = dense.copy()

        # fast path: one lost data chunk whose decode row is all 0/1 is
        # rebuilt by XOR alone
        if len(erased) == 1 and erased[0] < self.k:
            row = self._decode_rows(tuple(survivors), tuple(erased))[0]
            if set(np.unique(row)) <= {0, 1}:
                acc = np.zeros_like(out[0])
                for j, s in enumerate(survivors):
                    if row[j]:
                        acc ^= dense[s]
                out[erased[0]] = acc
                return out

        need_data = [e for e in erased if e < self.k]
        if need_data:
            rows = self._decode_rows(tuple(survivors), tuple(need_data))
            rec = gf.gf_matvec(rows, dense[survivors])
            for idx, e in enumerate(need_data):
                out[e] = rec[idx]
        need_par = [e for e in erased if e >= self.k]
        if need_par:
            rec = gf.gf_matvec(self.matrix[need_par, :], out[: self.k])
            for idx, e in enumerate(need_par):
                out[e] = rec[idx]
        return out

    def _decode_rows(self, survivors: tuple, targets: tuple) -> np.ndarray:
        key = (self.k, self.m, self.technique, survivors, targets)
        rows = _TABLE_CACHE.get(key)
        if rows is None:
            inv = gf.gf_invert_matrix(self.matrix[list(survivors), :])
            rows = np.stack([inv[t] for t in targets])
            _TABLE_CACHE.put(key, rows)
        return rows


class ErasureCodePluginIsa(ErasureCodePlugin):
    def factory(self, profile: Profile):
        technique = profile.get("technique", "reed_sol_van") or "reed_sol_van"
        if technique not in ("reed_sol_van", "cauchy"):
            raise ErasureCodeError(
                errno.ENOENT, f"unknown isa technique {technique!r}")
        return ErasureCodeIsa(technique)


def __erasure_code_init__(name: str, directory: str | None) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginIsa())

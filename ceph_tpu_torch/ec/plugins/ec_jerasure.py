"""CPU Reed-Solomon plugin ("jerasure" role).

The port of ceph_tpu/ec/plugins/ec_jerasure.py, filling the role of the
reference's jerasure plugin (src/erasure-code/jerasure/
ErasureCodeJerasure.{h,cc}): the default CPU codec, with the reference's
techniques:

  reed_sol_van   - systematic Vandermonde-derived matrix (reference :162)
  reed_sol_r6_op - RAID-6 specialization: P = XOR, Q = sum 2^j * d_j
                   (reference ErasureCodeJerasure.h:102)
  cauchy_orig    - Cauchy generator matrix, elementwise GF mult
  cauchy_good    - Cauchy matrix with its GF(2) bitmatrix expansion
                   (reference :265,353 use jerasure bitmatrix schedules;
                   the bytes are those of the matrix apply)
  liberation / blaum_roth / liber8tion - minimal-density RAID-6
                   bitmatrix codes (XOR-only, w-bit packets) built in
                   ec/bitmatrix.py (reference ErasureCodeJerasure.h:
                   198-246; same m=2 and w parameter contracts).

The GF region work runs on the host: gf.gf_matvec, which takes the
native SIMD library (common/native) for widths of 1 KiB and more.
Default profile k=2 m=1 technique=reed_sol_van mirrors the reference
plugin defaults (src/erasure-code/jerasure/ErasureCodePluginJerasure.cc).
"""

from __future__ import annotations

import errno

import numpy as np

from .. import bitmatrix as bm
from .. import gf
from ..base import SIMD_ALIGN, ErasureCode
from ..interface import ErasureCodeError, Profile
from ..registry import ErasureCodePlugin, ErasureCodePluginRegistry

__erasure_code_version__ = ErasureCodePlugin.abi_version

TECHNIQUES = (
    "reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good",
    "liberation", "blaum_roth", "liber8tion",
)


class ErasureCodeJerasure(ErasureCode):
    """Matrix RS codec over GF(2^8) with pluggable matrix technique."""

    technique = "reed_sol_van"

    MINIMAL_DENSITY = ("liberation", "blaum_roth", "liber8tion")

    def __init__(self, technique: str = "reed_sol_van"):
        super().__init__()
        self.technique = technique
        self.matrix: np.ndarray | None = None      # (k+m, k) over GF(2^8)
        self.bitmatrix: np.ndarray | None = None   # (8m, 8k) over GF(2)
        self.w = 8                                 # word size (bitmatrix)
        self._md_coding: np.ndarray | None = None  # (2w, kw) minimal-density
        self._md_gen: np.ndarray | None = None

    # -- setup --------------------------------------------------------------

    def init(self, profile: Profile) -> None:
        self.k = profile.to_int("k", 2)
        if self.k < 1:
            raise ErasureCodeError(errno.EINVAL, f"k={self.k} invalid")
        if self.technique in self.MINIMAL_DENSITY:
            # reference defaults: m=2 mandatory (ErasureCodeJerasure.cc:
            # 429-513); w=7 for liberation (prime), 6 for blaum_roth (w+1
            # prime — the legacy 7 is not double-erasure decodable, see
            # bitmatrix.blaum_roth_x), 8 for liber8tion
            self.m = profile.to_int("m", 2)
            self.w = profile.to_int(
                "w", {"liber8tion": 8, "blaum_roth": 6}.get(
                    self.technique, 7))
            if self.m != 2:
                raise ErasureCodeError(
                    errno.EINVAL, f"{self.technique} requires m=2")
            self._md_coding = bm.coding_matrix(self.technique, self.k,
                                               self.w)
            self._md_gen = bm.generator(self.technique, self.k, self.w)
            super().init(profile)
            return
        self.m = profile.to_int("m", 1)
        if self.k < 1 or self.m < 1:
            raise ErasureCodeError(errno.EINVAL,
                                   f"k={self.k} m={self.m} invalid")
        if self.k + self.m > gf.GF_SIZE:
            raise ErasureCodeError(
                errno.EINVAL, f"k+m={self.k + self.m} > {gf.GF_SIZE}")
        if self.technique == "reed_sol_r6_op" and self.m != 2:
            raise ErasureCodeError(errno.EINVAL, "reed_sol_r6_op requires m=2")
        self.matrix = self._build_matrix()
        if self.technique == "cauchy_good":
            self.bitmatrix = gf.expand_to_bitmatrix(self.matrix[self.k:])
        super().init(profile)

    def get_alignment(self) -> int:
        # minimal-density chunks are w packets: chunk_size % w == 0
        if self.technique in self.MINIMAL_DENSITY:
            return SIMD_ALIGN * self.w
        return SIMD_ALIGN

    def _build_matrix(self) -> np.ndarray:
        if self.technique == "reed_sol_van":
            return gf.vandermonde_rs_matrix(self.k, self.m)
        if self.technique == "reed_sol_r6_op":
            g = np.zeros((self.k + 2, self.k), dtype=np.uint8)
            g[: self.k] = np.eye(self.k, dtype=np.uint8)
            g[self.k, :] = 1                                   # P: XOR
            g[self.k + 1, :] = [gf.gf_pow(2, j) for j in range(self.k)]  # Q
            return g
        # cauchy_*
        return gf.cauchy_rs_matrix(self.k, self.m)

    # -- encode / decode ----------------------------------------------------

    def encode_chunks(self, chunks: np.ndarray) -> np.ndarray:
        if self.technique in self.MINIMAL_DENSITY:
            return bm.encode(self._md_coding, chunks, self.w)
        # the bitmatrix of cauchy_good computes identical bytes
        # (gf.bitmatrix_matvec); the table / native path is the fast one
        return gf.gf_matvec(self.matrix[self.k:], chunks)

    def decode_chunks(self, dense: np.ndarray, erasures) -> np.ndarray:
        """Reconstruct erased rows: invert the surviving generator rows.

        Mirrors jerasure_matrix_decode: take k surviving rows R of the
        generator G, invert the kxk matrix G[R], then erased chunk i =
        G[i] @ inv @ surviving-chunks (reference ErasureCodeJerasure.cc:195).
        """
        if self.technique in self.MINIMAL_DENSITY:
            return bm.decode(self._md_gen, dense, erasures, self.k, self.w)
        n = self.get_chunk_count()
        erased = set(erasures)
        survivors = [i for i in range(n) if i not in erased][: self.k]
        if len(survivors) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough survivors")
        inv = gf.gf_invert_matrix(self.matrix[survivors, :])
        out = dense.copy()
        need_data = [e for e in erased if e < self.k]
        need_par = [e for e in erased if e >= self.k]
        if need_data:
            rec = gf.gf_matvec(np.stack([inv[e] for e in need_data]),
                               dense[survivors])
            for idx, e in enumerate(need_data):
                out[e] = rec[idx]
        if need_par:
            # re-encode parity from the (now complete) data chunks
            rec = gf.gf_matvec(self.matrix[need_par, :], out[: self.k])
            for idx, e in enumerate(need_par):
                out[e] = rec[idx]
        return out


class ErasureCodePluginJerasure(ErasureCodePlugin):
    def factory(self, profile: Profile):
        technique = profile.get("technique", "reed_sol_van") or "reed_sol_van"
        if technique not in TECHNIQUES:
            raise ErasureCodeError(
                errno.ENOENT, f"unknown jerasure technique {technique!r}")
        return ErasureCodeJerasure(technique)


def __erasure_code_init__(name: str, directory: str | None) -> None:
    ErasureCodePluginRegistry.instance().add(
        name, ErasureCodePluginJerasure())

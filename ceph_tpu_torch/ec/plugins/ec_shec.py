"""SHEC plugin: Shingled Erasure Code.

The port's copy of ceph_tpu/ec/plugins/ec_shec.py (numpy and the port's
own ec/ modules; encode and decode run on the host, as in the JAX
package).  `ErasureCodeShec._gf_solve` is also the GF(2^8) system solve
of the port's CLAY plugin, which imports it from here as the
reference's does.

Fills the role of reference src/erasure-code/shec/ErasureCodeShec.{h,cc}
(k, m, c profile): m parity chunks each covering a sliding window
("shingle") of the data chunks, overlapping so that any failure pattern
of up to c chunks is recoverable while single-failure recovery reads
fewer than k chunks (recovery efficiency is the point of SHEC).

Construction: windows of width w = max(2, ceil(k * c / m)) (at most k)
start at (i * k) // m, cyclic, with coefficients from a Cauchy row (1
where it is 0), then init() VERIFIES by brute force that every erasure
pattern of size <= c is decodable (k+m is small; this check is the
contract the reference's recovery-efficiency calculators assume).
minimum_to_decode returns, for each erasure set, a minimal hitting set
of covering windows — fewer chunks than k for local failures.
"""

from __future__ import annotations

import errno
import itertools

import numpy as np

from .. import gf
from ..base import ErasureCode
from ..interface import ErasureCodeError, Profile
from ..registry import ErasureCodePlugin, ErasureCodePluginRegistry

__erasure_code_version__ = ErasureCodePlugin.abi_version


class ErasureCodeShec(ErasureCode):
    ALLOW_PARTIAL_DECODE = True

    def __init__(self):
        super().__init__()
        self.c = 0
        self.matrix: np.ndarray | None = None  # (m, k) with zero outside windows
        self.windows: list[list[int]] = []

    def init(self, profile: Profile) -> None:
        self.k = profile.to_int("k", 4)
        self.m = profile.to_int("m", 3)
        self.c = profile.to_int("c", 2)
        if not (1 <= self.c <= self.m <= self.k + self.m):
            raise ErasureCodeError(
                errno.EINVAL, f"bad k={self.k} m={self.m} c={self.c}")
        if self.c > self.m:
            raise ErasureCodeError(errno.EINVAL, "c must be <= m")
        self._build_matrix()
        super().init(profile)

    def _build_matrix(self) -> None:
        k, m, c = self.k, self.m, self.c
        # window width: each parity covers w consecutive (cyclic) data
        # chunks; total coverage m*w must give every chunk >= c covers.
        w = max(2, -(-k * c // m))
        if w > k:
            w = k
        cauchy = gf.cauchy_rs_matrix(k, m)[k:]
        mat = np.zeros((m, k), dtype=np.uint8)
        self.windows = []
        for i in range(m):
            start = (i * k) // m
            cols = [(start + j) % k for j in range(w)]
            self.windows.append(sorted(set(cols)))
            for j in cols:
                mat[i, j] = cauchy[i, j] if cauchy[i, j] else 1
        self.matrix = mat
        # Contract check: every erasure pattern of size <= c decodable.
        n = k + m
        for r in range(1, c + 1):
            for pattern in itertools.combinations(range(n), r):
                if not self._decodable(set(pattern)):
                    raise ErasureCodeError(
                        errno.EINVAL,
                        f"shec k={k} m={m} c={c}: pattern {pattern} "
                        f"not recoverable; profile unsupported")

    def _full_matrix(self) -> np.ndarray:
        g = np.zeros((self.k + self.m, self.k), dtype=np.uint8)
        g[: self.k] = np.eye(self.k, dtype=np.uint8)
        g[self.k:] = self.matrix
        return g

    def _decodable(self, erased: set[int]) -> bool:
        data_erased = [e for e in erased if e < self.k]
        if not data_erased:
            return True
        avail_parity = [i for i in range(self.m)
                        if self.k + i not in erased]
        avail_data = [j for j in range(self.k) if j not in erased]
        # rank test: can the erased data columns be solved from available
        # parity rows restricted to erased columns?
        rows = []
        for i in avail_parity:
            rows.append([self.matrix[i, j] for j in data_erased])
        a = np.array(rows, dtype=np.uint8) if rows else \
            np.zeros((0, len(data_erased)), dtype=np.uint8)
        return self._gf_rank(a) == len(data_erased)

    @staticmethod
    def _gf_rank(a: np.ndarray) -> int:
        a = a.astype(np.uint8).copy()
        rank = 0
        rows, cols = a.shape
        for col in range(cols):
            piv = next((r for r in range(rank, rows) if a[r, col]), None)
            if piv is None:
                continue
            a[[rank, piv]] = a[[piv, rank]]
            lut = gf.mul_table()[gf.gf_inv(int(a[rank, col]))]
            a[rank] = lut[a[rank]]
            for r in range(rows):
                if r != rank and a[r, col]:
                    a[r] ^= gf.mul_table()[int(a[r, col])][a[rank]]
            rank += 1
        return rank

    # -- codec --------------------------------------------------------------

    def encode_chunks(self, chunks: np.ndarray) -> np.ndarray:
        return gf.gf_matvec(self.matrix, chunks)

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        missing = want - avail
        if not missing:
            return {i: [(0, 1)] for i in want}
        need: set[int] = set(want & avail)
        if len(missing) <= self.c:
            helper_set = self._local_helpers(missing, avail)
            if helper_set is not None:
                return {h: [(0, 1)] for h in (helper_set | need)}
        # generic: any k available data+parity chunks that decode
        usable = sorted(avail)
        if len(usable) < self.k:
            raise ErasureCodeError(errno.EIO, "shec: not enough chunks")
        return {i: [(0, 1)] for i in (set(usable[: self.k]) | need)}

    def _local_helpers(self, missing: set[int],
                       avail: set[int]) -> set[int] | None:
        """Smallest window-based helper set that recovers `missing`, or
        None when no local recovery exists (the recovery-efficiency path
        the reference's shec calculators optimize)."""
        helpers: set[int] = set()
        parities: list[int] = []
        data_missing = sorted(e for e in missing if e < self.k)
        for e in data_missing:
            cover = [i for i in range(self.m)
                     if e in self.windows[i] and (self.k + i) in avail
                     and (self.k + i) not in missing]
            if not cover:
                return None
            # prefer a window whose other members are all available
            cover.sort(key=lambda i: sum(
                1 for j in self.windows[i] if j != e and j not in avail))
            i = cover[0]
            parities.append(i)
            helpers.add(self.k + i)
            helpers |= {j for j in self.windows[i] if j != e}
        # lost parity chunks rebuild from their window's data directly
        for e in (e for e in missing if e >= self.k):
            helpers |= set(self.windows[e - self.k])
        if not helpers <= avail:
            return None
        # solvability: chosen parity rows restricted to the missing data
        # columns must have full rank (all other window terms are in
        # helpers, hence known)
        if data_missing:
            a = np.array([[self.matrix[i, j] for j in data_missing]
                          for i in parities], dtype=np.uint8)
            if self._gf_rank(a) < len(data_missing):
                return None
        return helpers

    def decode(self, want_to_read, chunks, chunk_size):
        self._unsolved = set()   # base may shortcut past decode_chunks
        out = super().decode(want_to_read, chunks, chunk_size)
        bad = set(want_to_read) & self._unsolved
        if bad:
            raise ErasureCodeError(
                errno.EIO, f"shec: chunks {sorted(bad)} unrecoverable "
                f"from provided set")
        return out

    def decode_chunks(self, dense: np.ndarray, erasures) -> np.ndarray:
        """Recover what the provided chunks allow.

        Pass 1 propagates single-unknown windows (the shingle-local
        repair).  Pass 2 solves the restricted linear system over the
        remaining unknown data columns using parity rows whose windows
        are fully known-or-unknown-in-system.  Chunks that stay
        unrecoverable are recorded in self._unsolved; decode() errors if
        any of them were wanted (partial helper sets legitimately leave
        unwanted chunks unsolved).
        """
        out = dense.copy()
        erased = set(erasures)
        unknown = set(e for e in erased if e < self.k)
        known_parity = {i for i in range(self.m) if self.k + i not in erased}
        lut_all = gf.mul_table()

        def row_rhs(i: int, unknowns: list[int]) -> np.ndarray:
            rhs = out[self.k + i].copy()
            for j in self.windows[i]:
                if j not in unknowns and j not in unknown:
                    cij = int(self.matrix[i, j])
                    if cij:
                        rhs ^= lut_all[cij][out[j]]
            return rhs

        # pass 1: single-unknown propagation
        progress = True
        while progress and unknown:
            progress = False
            for i in known_parity:
                win_unknown = [j for j in self.windows[i] if j in unknown]
                if len(win_unknown) == 1:
                    j = win_unknown[0]
                    rhs = row_rhs(i, [j])
                    inv = gf.gf_inv(int(self.matrix[i, j]))
                    out[j] = lut_all[inv][rhs]
                    unknown.discard(j)
                    progress = True
        # pass 2: restricted system over remaining unknowns
        if unknown:
            unknowns = sorted(unknown)
            usable = [i for i in known_parity
                      if all(j not in unknown or j in unknowns
                             for j in self.windows[i])]
            rows = [[self.matrix[i, j] for j in unknowns] for i in usable]
            a = np.array(rows, dtype=np.uint8) if rows else \
                np.zeros((0, len(unknowns)), dtype=np.uint8)
            if rows and self._gf_rank(a) == len(unknowns):
                rhs = np.stack([row_rhs(i, unknowns) for i in usable])
                sol = self._gf_solve(a, rhs)
                if sol is not None:
                    for idx, e in enumerate(unknowns):
                        out[e] = sol[idx]
                    unknown.clear()
        # recompute erased parities whose windows are fully known
        self._unsolved = set(unknown)
        for e in (e for e in erased if e >= self.k):
            win = self.windows[e - self.k]
            if not any(j in unknown for j in win):
                acc = np.zeros_like(out[0])
                for j in win:
                    acc ^= lut_all[int(self.matrix[e - self.k, j])][out[j]]
                out[e] = acc
            else:
                self._unsolved.add(e)
        return out

    @staticmethod
    def _gf_solve(a: np.ndarray, rhs: np.ndarray) -> np.ndarray | None:
        """Solve a (rows x unknowns) GF system for each byte column."""
        rows, unknowns = a.shape
        aug_a = a.copy()
        aug_r = rhs.copy()
        lut_all = gf.mul_table()
        rank = 0
        for col in range(unknowns):
            piv = next((r for r in range(rank, rows) if aug_a[r, col]), None)
            if piv is None:
                return None
            aug_a[[rank, piv]] = aug_a[[piv, rank]]
            aug_r[[rank, piv]] = aug_r[[piv, rank]]
            inv = gf.gf_inv(int(aug_a[rank, col]))
            lut = lut_all[inv]
            aug_a[rank] = lut[aug_a[rank]]
            aug_r[rank] = lut[aug_r[rank]]
            for r in range(rows):
                if r != rank and aug_a[r, col]:
                    c = int(aug_a[r, col])
                    aug_a[r] ^= lut_all[c][aug_a[rank]]
                    aug_r[r] ^= lut_all[c][aug_r[rank]]
            rank += 1
            if rank == unknowns:
                break
        return aug_r[:unknowns]


class ErasureCodePluginShec(ErasureCodePlugin):
    def factory(self, profile: Profile):
        return ErasureCodeShec()


def __erasure_code_init__(name: str, directory: str | None) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginShec())

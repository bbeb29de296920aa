"""Minimal-density RAID-6 bitmatrix codes: liberation / blaum_roth /
liber8tion.

Fills the role of the reference's jerasure minimal-density techniques
(src/erasure-code/jerasure/ErasureCodeJerasure.h:198-246 — the
ErasureCodeJerasureLiberation/BlaumRoth/Liber8tion classes, whose
bitmatrix constructors live in the jerasure library's liberation.c).
These codes protect k data chunks with m=2 parity chunks where every
chunk is treated as w packets of bits and parity is PURE XOR of
packets — no GF multiplications — with close to the theoretical
minimum number of XORs.

Construction model (all three techniques):

  P = d_0 ^ d_1 ^ ... ^ d_{k-1}              (chunkwise XOR)
  Q = X_0 d_0 ^ X_1 d_1 ^ ... ^ X_{k-1} d_{k-1}

where each d_j is a length-w vector of packets and each X_j is a w x w
0/1 matrix.  The code corrects any two chunk erasures iff every X_j
and every X_i ^ X_j (i != j) is invertible over GF(2):

  * two data chunks i<j lost:  (X_i ^ X_j) d_i = Q' ^ X_j P'
  * one data chunk + P lost:   X_i d_i = Q'
  * anything else reduces to XOR or re-encode.

Techniques (same parameter contracts as the reference):

  liberation  — w prime > 2, k <= w (Plank, "The RAID-6 Liberation
                Codes", FAST 2008): X_j is the rotation matrix sigma^j
                (ones at (i, (i+j) mod w)) plus, for j > 0, one extra
                one at row r = j(w-1)/2 mod w, column (r+j-1) mod w.
                Total density kw + k - 1 = the proven minimum.
  blaum_roth  — w+1 prime (Blaum & Roth, "On Lowest Density MDS
                Codes", IEEE Trans. IT 1999): X_j represents
                multiplication by x^j in the polynomial ring
                GF(2)[x] / M_p(x), p = w+1, M_p(x) = 1 + x + ... + x^w.
                Column c of X_j is x^(j+c) mod M_p(x).  Invertibility
                of X_i ^ X_j follows from gcd(x^d + 1, M_p) = 1 for
                p prime.  Deviation: the legacy w=7 the reference
                tolerates is rejected here (see blaum_roth_x).
  liber8tion  — w = 8 exactly, m = 2, k <= 8 (role of Plank's
                liber8tion code).  w=8 has no liberation construction
                (8 is not prime) and the reference's matrix is an
                unpublished-formula search table, so the X_j here are
                the multiplication matrices of the k LIGHTEST elements
                of GF(2^8)/0x11d (column c of X_e = e*x^c): distinct
                nonzero elements make every X_i ^ X_j the matrix of
                multiplication by e_i + e_j != 0, hence invertible —
                decodability is a theorem, not a search result.  Total
                Q density for k=8 is 111 ones vs the 71 theoretical
                minimum and ~256 for a Cauchy bitmatrix; a documented
                deviation: low-density, not provably minimal, and not
                byte-compatible with jerasure's table.

A copy of ceph_tpu/ec/bitmatrix.py (numpy only), kept in the port so
that the port imports nothing of the JAX package; liber8tion's matrix
is the same, so the pinned corpus digests (tests/corpus/) match.  The
CPU path below vectorizes packet XORs with numpy.
"""

from __future__ import annotations

import errno
from functools import lru_cache

import numpy as np

from .interface import ErasureCodeError


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(n ** 0.5) + 1):
        if n % p == 0:
            return False
    return True


# -- GF(2) linear algebra (rows as python ints for speed) --------------------

def _to_rowints(mat: np.ndarray) -> list[int]:
    w = mat.shape[1]
    return [int("".join("1" if mat[i, w - 1 - c] else "0"
                        for c in range(w)), 2) if mat[i].any() else 0
            for i in range(mat.shape[0])]


def gf2_invertible(mat: np.ndarray) -> bool:
    """Gaussian elimination over GF(2); True iff square mat has full rank."""
    n, m = mat.shape
    if n != m:
        return False
    rows = _to_rowints(mat)
    rank = 0
    for col in range(m):
        bit = 1 << col
        piv = next((r for r in range(rank, n) if rows[r] & bit), None)
        if piv is None:
            return False
        rows[rank], rows[piv] = rows[piv], rows[rank]
        for r in range(n):
            if r != rank and rows[r] & bit:
                rows[r] ^= rows[rank]
        rank += 1
    return True


def gf2_inverse(mat: np.ndarray) -> np.ndarray:
    """Inverse of a square 0/1 matrix over GF(2) (raises on singular)."""
    n = mat.shape[0]
    a = mat.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r, col]), None)
        if piv is None:
            raise ErasureCodeError(errno.EIO, "singular GF(2) matrix")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv


# -- X-matrix constructions ---------------------------------------------------

def rotation(w: int, s: int) -> np.ndarray:
    x = np.zeros((w, w), dtype=np.uint8)
    for i in range(w):
        x[i, (i + s) % w] = 1
    return x


def liberation_x(k: int, w: int) -> list[np.ndarray]:
    if not is_prime(w) or w <= 2:
        raise ErasureCodeError(
            errno.EINVAL, f"liberation: w={w} must be prime > 2")
    if k > w:
        raise ErasureCodeError(errno.EINVAL,
                               f"liberation: k={k} must be <= w={w}")
    xs = []
    for j in range(k):
        x = rotation(w, j)
        if j > 0:
            r = (j * ((w - 1) // 2)) % w
            x[r, (r + j - 1) % w] ^= 1
        xs.append(x)
    return xs


def blaum_roth_x(k: int, w: int) -> list[np.ndarray]:
    p = w + 1
    # Deviation from the reference: it tolerates w=7 (the legacy
    # Firefly default) for old-data compatibility, but p=8 gives
    # M_8(x) = (1+x)^7 so EVERY X_i^X_j is singular — the code cannot
    # correct any double data-chunk erasure.  New pools must not be
    # creatable in that state; we reject it.
    if w <= 2 or not is_prime(p):
        raise ErasureCodeError(
            errno.EINVAL,
            f"blaum_roth: w+1={p} must be prime (w > 2); note w=7 "
            f"(legacy default) is NOT double-erasure decodable")
    if k > w:
        raise ErasureCodeError(errno.EINVAL,
                               f"blaum_roth: k={k} must be <= w={w}")

    # powers of x in GF(2)[x]/M_p(x), M_p = 1 + x + ... + x^w
    def xpow(e: int) -> np.ndarray:
        poly = np.zeros(w, dtype=np.uint8)
        poly[0] = 1
        for _ in range(e):
            carry = poly[w - 1]
            poly[1:] = poly[:-1]
            poly[0] = 0
            if carry:               # x^w = 1 + x + ... + x^(w-1)
                poly ^= 1
        return poly

    xs = []
    for j in range(k):
        x = np.zeros((w, w), dtype=np.uint8)
        for c in range(w):
            x[:, c] = xpow(j + c)
        xs.append(x)
    return xs


def _gf256_mult_matrix(e: int) -> np.ndarray:
    """8x8 GF(2) matrix of y -> e*y in GF(2^8)/0x11d: column c is the
    bit vector of e * x^c."""
    x = np.zeros((8, 8), dtype=np.uint8)
    cur = e
    for c in range(8):
        for i in range(8):
            x[i, c] = (cur >> i) & 1
        cur <<= 1
        if cur & 0x100:
            cur ^= 0x11D
    return x


@lru_cache(maxsize=None)
def _lightest_elements(k: int) -> tuple[int, ...]:
    """The k elements of GF(2^8) with the sparsest multiplication
    matrices (ties by element value): 1, 2, 142, 4, 71, 8, 70, 173..."""
    ranked = sorted(range(1, 256),
                    key=lambda e: (int(_gf256_mult_matrix(e).sum()), e))
    return tuple(ranked[:k])


def liber8tion_x(k: int) -> list[np.ndarray]:
    if k > 8:
        raise ErasureCodeError(errno.EINVAL,
                               f"liber8tion: k={k} must be <= 8")
    return [_gf256_mult_matrix(e) for e in _lightest_elements(k)]


# -- coding matrix + codec paths ---------------------------------------------

def coding_matrix(technique: str, k: int, w: int) -> np.ndarray:
    """(2w, kw) GF(2) matrix: top w rows produce P, bottom w rows Q.
    Validates the pairwise invertibility contract so a non-decodable
    parameter combination fails at init, not at recovery time."""
    if technique == "liberation":
        xs = liberation_x(k, w)
    elif technique == "blaum_roth":
        xs = blaum_roth_x(k, w)
    elif technique == "liber8tion":
        if w != 8:
            raise ErasureCodeError(errno.EINVAL,
                                   f"liber8tion: w={w} must be 8")
        xs = liber8tion_x(k)
    else:
        raise ErasureCodeError(errno.ENOENT,
                               f"unknown bitmatrix technique {technique!r}")
    for j, x in enumerate(xs):
        if not gf2_invertible(x):
            raise ErasureCodeError(
                errno.EINVAL, f"{technique}: X_{j} singular (k={k}, w={w})")
        for i in range(j):
            if not gf2_invertible(x ^ xs[i]):
                raise ErasureCodeError(
                    errno.EINVAL,
                    f"{technique}: X_{i}^X_{j} singular (k={k}, w={w}) — "
                    f"this parameter combination cannot correct the "
                    f"({i},{j}) data-chunk erasure pair")
    b = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        b[:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        b[w:, j * w:(j + 1) * w] = xs[j]
    return b


def generator(technique: str, k: int, w: int) -> np.ndarray:
    """((k+2)w, kw): identity rows for data chunks + coding_matrix."""
    g = np.zeros(((k + 2) * w, k * w), dtype=np.uint8)
    g[: k * w] = np.eye(k * w, dtype=np.uint8)
    g[k * w:] = coding_matrix(technique, k, w)
    return g


def _xor_apply(mat: np.ndarray, packets: np.ndarray) -> np.ndarray:
    """rows of `mat` select packets to XOR: out[r] = XOR of packets[c]
    where mat[r, c] == 1."""
    out = np.zeros((mat.shape[0], packets.shape[1]), dtype=np.uint8)
    for r in range(mat.shape[0]):
        idx = np.nonzero(mat[r])[0]
        if idx.size:
            out[r] = np.bitwise_xor.reduce(packets[idx], axis=0)
    return out


def encode(coding: np.ndarray, chunks: np.ndarray, w: int) -> np.ndarray:
    """chunks (k, chunk_size) -> parity (2, chunk_size); chunk_size
    must be a multiple of w (each chunk = w packets)."""
    k, chunk_size = chunks.shape
    if chunk_size % w:
        raise ErasureCodeError(
            errno.EINVAL, f"chunk size {chunk_size} not divisible by w={w}")
    pl = chunk_size // w
    packets = chunks.reshape(k * w, pl)
    return _xor_apply(coding, packets).reshape(2, chunk_size)


def decode(gen: np.ndarray, dense: np.ndarray, erasures: list[int],
           k: int, w: int) -> np.ndarray:
    """Rebuild erased chunk rows of dense ((k+2), chunk_size) from any
    k surviving chunks (mirrors the matrix-decode shape of
    jerasure_bitmatrix_decode)."""
    n, chunk_size = dense.shape
    pl = chunk_size // w
    erased = set(erasures)
    survivors = [i for i in range(n) if i not in erased][:k]
    if len(survivors) < k:
        raise ErasureCodeError(errno.EIO, "not enough survivors")
    sub = np.concatenate([gen[s * w:(s + 1) * w] for s in survivors])
    inv = gf2_inverse(sub)                      # (kw, kw)
    out = dense.copy()
    need_data = [e for e in erased if e < k]
    need_par = [e for e in erased if e >= k]
    if need_data:
        spackets = np.concatenate(
            [dense[s].reshape(w, pl) for s in survivors])
        data_packets = _xor_apply(inv, spackets)      # all kw data packets
        for e in need_data:
            out[e] = data_packets[e * w:(e + 1) * w].reshape(chunk_size)
    if need_par:
        # re-encode parity from (now complete) data chunks
        parity = encode(gen[k * w:], out[:k], w)
        for e in need_par:
            out[e] = parity[e - k]
    return out

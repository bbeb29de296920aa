"""crc32c (Castagnoli) — the data-plane checksum.

Same conventions as the reference's `bufferlist::crc32c`
(src/include/buffer.h:1199, src/common/crc32c.cc): reflected polynomial
0x82F63B78, caller-supplied seed, no final xor.

`crc32c`, `crc32c_rows`, `crc32c_zeros` and `crc32c_combine` call the
native library (common/native.py: SSE4.2 or slice-by-8 over
native/crc32c.c) when it builds.  Without a C compiler they run on
numpy tables, which give the same values: vectorised so that a whole
shard row costs a few thousand array operations rather than one Python
step per byte.  The crc is GF(2)-linear in (seed, bytes):

    crc(B, seed) = A_|B| . seed  ^  L(B),      L(B) = crc(B, 0)
    L(B1 || B2)  = A_|B2| . L(B1)  ^  L(B2)

where A_n is the 32x32 "advance over n zero bytes" operator.  A row is
cut into equal pieces (front-padded with zeros, which leave L
unchanged), every piece of every row walks the byte table in one
vectorised pass, and the pieces fold pairwise in log2(pieces) levels
with the A operators.  Operators are kept as 32 uint32 columns (column
b = A . e_b), built for powers of two by squaring and cached.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np

from . import native
from .util import next_pow2

POLY_REFLECTED = 0x82F63B78
_BITS = np.arange(32, dtype=np.uint32)


@functools.lru_cache(maxsize=1)
def _sw_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY_REFLECTED if c & 1 else c >> 1
        t[i] = c
    return t


def apply_op(op: np.ndarray, state) -> np.ndarray:
    """A . state for an operator of 32 uint32 columns; `state` is a
    uint32 array of any shape (vectorised over it)."""
    s = np.asarray(state, dtype=np.uint32)
    bits = (s[..., None] >> _BITS) & np.uint32(1)
    return np.bitwise_xor.reduce(bits * op, axis=-1)


def _apply_int(op: np.ndarray, crc: int) -> int:
    acc = 0
    b = 0
    while crc:
        if crc & 1:
            acc ^= int(op[b])
        crc >>= 1
        b += 1
    return acc


@functools.lru_cache(maxsize=64)
def _pow2_op(j: int) -> np.ndarray:
    """Operator advancing a crc state over 2**j zero bytes."""
    if j == 0:
        t = _sw_table()
        e = np.uint32(1) << _BITS
        return t[e & np.uint32(0xFF)] ^ (e >> np.uint32(8))
    half = _pow2_op(j - 1)
    return apply_op(half, half)


@functools.lru_cache(maxsize=256)
def advance_op(nbytes: int) -> np.ndarray:
    """Operator A_nbytes as 32 uint32 columns (column b = A . e_b)."""
    op = np.uint32(1) << _BITS          # identity
    j = 0
    n = nbytes
    while n:
        if n & 1:
            op = apply_op(_pow2_op(j), op)
        n >>= 1
        j += 1
    return op


def crc32c_zeros(crc: int, length: int) -> int:
    """Advance `crc` over `length` zero bytes in O(log length)."""
    crc &= 0xFFFFFFFF
    if length == 0:
        return crc
    lib = native.load()
    if lib is not None:
        return lib.ceph_tpu_crc32c_zeros(crc, length)
    j = 0
    while length:
        if length & 1:
            crc = _apply_int(_pow2_op(j), crc)
        length >>= 1
        j += 1
    return crc


def _linear_rows(rows: np.ndarray) -> np.ndarray:
    """L = crc(row, 0) of every row of an (R, n) uint8 matrix."""
    r, n = rows.shape
    if n == 0:
        return np.zeros(r, dtype=np.uint32)
    piece = max(16, next_pow2(math.isqrt(n)))
    npieces = next_pow2(-(-n // piece))
    pad = npieces * piece - n
    if pad:
        rows = np.concatenate(
            [np.zeros((r, pad), dtype=np.uint8), rows], axis=1)
    # (piece, R*npieces): column walk over contiguous rows of states
    cols = np.ascontiguousarray(rows.reshape(r * npieces, piece).T)
    t = _sw_table()
    c = np.zeros(r * npieces, dtype=np.uint32)
    mask = np.uint32(0xFF)
    eight = np.uint32(8)
    for col in cols:
        c = t[(c ^ col) & mask] ^ (c >> eight)
    c = c.reshape(r, npieces)
    size = piece
    while c.shape[1] > 1:
        left, right = c[:, 0::2], c[:, 1::2]
        c = apply_op(advance_op(size), left) ^ right
        size *= 2
    return c[:, 0]


def crc32c_rows(rows: np.ndarray, seeds) -> list[int]:
    """Per-row crc32c of a (R, L) byte matrix, row r seeded seeds[r] —
    the host fold of one encoded run's k+m shard rows in one pass
    (HashInfo.append and the ECBackend plain-path drain fold)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if rows.ndim == 1:
        rows = rows[None]
    lib = native.load()
    if lib is not None:
        n = rows.shape[1]
        return [lib.ceph_tpu_crc32c(int(s) & 0xFFFFFFFF, _ptr(rows[r]), n)
                for r, s in enumerate(seeds)]
    lin = _linear_rows(rows)
    seeds = np.array([int(s) & 0xFFFFFFFF for s in seeds], dtype=np.uint32)
    out = apply_op(advance_op(rows.shape[1]), seeds) ^ lin
    return [int(v) for v in out]


def crc32c(data, crc: int = 0xFFFFFFFF) -> int:
    """crc32c of `data` seeded with `crc` (default matches bufferlist's -1
    convention for standalone checksums)."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).view(np.uint8).ravel()
    else:
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return crc32c_rows(buf[None], [crc])[0]


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """crc of A||B from crc(A) (seeded arbitrarily) and crc(B) (seeded 0)."""
    lib = native.load()
    if lib is not None:
        return lib.ceph_tpu_crc32c_combine(crc_a & 0xFFFFFFFF,
                                           crc_b & 0xFFFFFFFF, len_b)
    return crc32c_zeros(crc_a, len_b) ^ (crc_b & 0xFFFFFFFF)


def _ptr(row: np.ndarray):
    """A contiguous uint8 row as the library's `const uint8_t *`,
    without a copy."""
    return ctypes.cast(row.ctypes.data, ctypes.c_char_p)

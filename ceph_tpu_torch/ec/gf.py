"""GF(2^8) arithmetic core for Reed-Solomon erasure codes (host, numpy).

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d),
the same polynomial gf-complete and ISA-L use for w=8.

Two device representations are built from these tables:

* product tables — for a (r, k) coefficient matrix, the 256-byte
  multiply-by-c lookup table of every coefficient, (r, k, 256) uint8.
  The CUDA kernels (csrc/) stage them in shared memory and XOR table
  products, the GPU analog of ISA-L's table-driven region multiply.
* bit-matrices — multiplication by a constant c is GF(2)-linear on the
  8 bits of the operand, so a (r, k) matrix expands to an (8r, 8k) 0/1
  matrix and encode is one {0,1}-matmul mod 2.  The plain PyTorch
  versions of the kernels compute it that way, a different algorithm
  from the kernels' lookups, so comparing the two is a real check.
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D
GF_SIZE = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """Log/antilog tables for the generator alpha=2 of GF(2^8)/0x11d."""
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]  # wraparound so exp[a+b] works without mod
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar multiply in GF(2^8)."""
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + int(GF_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(GF_EXP[(255 - int(GF_LOG[a])) % 255])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """(256, 256) uint8 full multiplication table; MUL[a][b] = a*b.
    Row c is the byte-LUT for multiply-by-c."""
    a = np.arange(256)
    la = GF_LOG[a][:, None]
    lb = GF_LOG[a][None, :]
    out = GF_EXP[(la + lb) % 255].astype(np.uint8)
    out[0, :] = 0
    out[:, 0] = 0
    return out


def product_tables(mat: np.ndarray) -> np.ndarray:
    """(r, k) coefficients -> (r, k, 256) uint8: out[i, j, x] =
    mat[i, j] * x.  The operand the CUDA kernels stage in shared
    memory (r*k*256 bytes: 6 KiB at k=8, m=3)."""
    mat = np.asarray(mat, dtype=np.uint8)
    return np.ascontiguousarray(mul_table()[mat])


def gf_matvec(mat: np.ndarray, chunks: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix x "vector of chunks" product on the host.

    mat: (r, k) uint8 coefficient matrix; chunks: (k, n) uint8.
    Returns (r, n) uint8: out[i] = XOR_j mat[i,j] * chunks[j]."""
    r, k = mat.shape
    assert chunks.shape[0] == k, (mat.shape, chunks.shape)
    out = np.zeros((r, chunks.shape[1]), dtype=np.uint8)
    lut = mul_table()
    for i in range(r):
        acc = out[i]
        for j in range(k):
            c = int(mat[i, j])
            if c == 0:
                continue
            if c == 1:
                acc ^= chunks[j]
            else:
                acc ^= lut[c][chunks[j]]
    return out


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product of small coefficient matrices (uint8)."""
    r, k = a.shape
    k2, c = b.shape
    assert k == k2
    out = np.zeros((r, c), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            acc = 0
            for t in range(k):
                acc ^= gf_mul(int(a[i, t]), int(b[t, j]))
            out[i, j] = acc
    return out


def gf_invert_matrix(mat: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination.
    Raises ValueError if singular (reference behavior:
    jerasure_matrix_decode / ISA-L gf_gen_decode_matrix)."""
    n = mat.shape[0]
    assert mat.shape == (n, n)
    a = mat.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = -1
        for row in range(col, n):
            if a[row, col]:
                pivot = row
                break
        if pivot < 0:
            raise ValueError("singular GF(2^8) matrix")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pv = gf_inv(int(a[col, col]))
        if pv != 1:
            lut = mul_table()[pv]
            a[col] = lut[a[col]]
            inv[col] = lut[inv[col]]
        for row in range(n):
            if row != col and a[row, col]:
                lut = mul_table()[int(a[row, col])]
                a[row] ^= lut[a[col]]
                inv[row] ^= lut[inv[col]]
    return inv


# ----------------------------------------------------------------------------
# Bit-matrix expansion (the plain versions' representation)
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _bitmatrix_table() -> np.ndarray:
    """(256, 8, 8) uint8: BITMAT[c] is M_c with bits(c*x) = M_c @ bits(x).
    Bit order is LSB-first; column j of M_c holds bits(c * 2^j)."""
    prods = mul_table()[:, [1 << j for j in range(8)]]      # (256, 8 j)
    bits = (prods[:, None, :] >> np.arange(8)[None, :, None]) & 1
    return bits.astype(np.uint8)                             # [c, i, j]


def expand_to_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """Expand an (r, k) GF(2^8) matrix to an (8r, 8k) GF(2) 0/1 matrix
    whose block (i, j) is the 8x8 bit-matrix of coefficient mat[i, j]
    (the Cauchy-bitmatrix idea of jerasure's cauchy_good schedules,
    recast as a dense matmul)."""
    r, k = mat.shape
    bm = _bitmatrix_table()[np.asarray(mat, dtype=np.uint8)]  # (r,k,8,8)
    return np.ascontiguousarray(bm.transpose(0, 2, 1, 3).reshape(8 * r, 8 * k))


# ----------------------------------------------------------------------------
# Generator matrix constructions
# ----------------------------------------------------------------------------

def vandermonde_rs_matrix(k: int, m: int) -> np.ndarray:
    """Systematic (k+m, k) RS generator matrix from a Vandermonde matrix
    V[i,j] = i^j, column-reduced so the top k rows are the identity
    (reference: jerasure reed_sol_vandermonde_coding_matrix)."""
    n = k + m
    if n > GF_SIZE:
        raise ValueError(f"k+m={n} exceeds GF(2^8) point count")
    v = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            v[i, j] = gf_pow(i, j) if i else (1 if j == 0 else 0)
    top_inv = gf_invert_matrix(v[:k, :])
    return gf_matmul(v, top_inv)


def cauchy_rs_matrix(k: int, m: int) -> np.ndarray:
    """Systematic (k+m, k) generator: identity on top of a Cauchy block
    C[i,j] = 1/(x_i + y_j), x_i = k+i, y_j = j (reference cauchy_orig /
    ISA-L kCauchy)."""
    if k + m > GF_SIZE:
        raise ValueError(f"k+m={k + m} exceeds GF(2^8) point count")
    g = np.zeros((k + m, k), dtype=np.uint8)
    g[:k, :] = np.eye(k, dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            g[k + i, j] = gf_inv((k + i) ^ j)
    return g


def recovery_matrix(matrix: np.ndarray, k: int, survivors, targets
                    ) -> np.ndarray:
    """(len(targets), k) GF(2^8) coefficients rebuilding `targets` shards
    from the k `survivors` rows of the systematic generator `matrix`
    ((k+m, k)) (reference ECUtil::decode inversion, src/osd/ECUtil.cc:9;
    ISA-L decode tables, ErasureCodeIsa.cc:385)."""
    inv = gf_invert_matrix(matrix[list(survivors), :])
    rows = []
    for t in targets:
        if t < k:
            rows.append(inv[t])
        else:
            rows.append(gf_matmul(matrix[t:t + 1], inv)[0])
    return np.stack(rows).astype(np.uint8)

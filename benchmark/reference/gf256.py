"""GF(2^8) arithmetic for any irreducible polynomial, in NumPy, and
the GF(2^8) matrix apply in plain PyTorch.

A configuration states its field's polynomial (`field_polynomial`;
ISA-L's and jerasure's is x^8 + x^4 + x^3 + x^2 + 1, 0x11d) and its
generator's construction (`technique`).  A `Field` is built from its
polynomial alone: products by carry-less multiplication and reduction,
inverses by search, so the same code serves the stated field and the
control's (another irreducible polynomial: `control_poly`).  A
technique the reference does not implement is refused, never replaced
by another.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

STATED_POLY = 0x11D
CONTROL_POLY = 0x11B
TECHNIQUES = ("cauchy", "reed_sol_van")


def poly_of(cfg: dict) -> int:
    """The polynomial a configuration states, as "0x11d" or 285."""
    val = cfg["field_polynomial"]
    return int(val, 0) if isinstance(val, str) else int(val)


def technique_of(cfg: dict) -> str:
    """The generator construction a configuration states: its plugin
    profile's `technique`, else its own (a CLAY plane's base code)."""
    tech = cfg.get("profile", {}).get("technique") or cfg.get("technique")
    if tech not in TECHNIQUES:
        raise ValueError(f"the reference implements the techniques "
                         f"{TECHNIQUES}, not {tech!r}")
    return tech


def control_poly(stated: int) -> int:
    """Another irreducible polynomial than the stated one."""
    return CONTROL_POLY if stated != CONTROL_POLY else STATED_POLY


def _clmul_reduce(a: int, b: int, poly: int) -> int:
    acc = 0
    while b:
        if b & 1:
            acc ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= poly
    return acc


class Field:
    """GF(2^8) modulo `poly` (degree 8, irreducible)."""

    def __init__(self, poly: int = STATED_POLY):
        self.poly = poly
        mul = np.zeros((256, 256), dtype=np.uint8)
        for a in range(256):
            for b in range(a, 256):
                mul[a, b] = mul[b, a] = _clmul_reduce(a, b, poly)
        self.mul = mul
        inv = np.zeros(256, dtype=np.uint8)
        for a in range(1, 256):
            hits = np.nonzero(mul[a] == 1)[0]
            if hits.size != 1:
                raise ValueError(f"0x{poly:x} is not irreducible")
            inv[a] = hits[0]
        self.inv = inv

    def matmul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a = np.asarray(a, dtype=np.uint8)
        b = np.asarray(b, dtype=np.uint8)
        out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
        for i in range(a.shape[0]):
            for j in range(a.shape[1]):
                out[i] ^= self.mul[a[i, j]][b[j]]
        return out

    def invert(self, mat: np.ndarray) -> np.ndarray:
        """Gauss-Jordan inverse of a square matrix; raises ValueError
        where it is singular."""
        n = mat.shape[0]
        aug = np.concatenate([np.asarray(mat, dtype=np.uint8),
                              np.eye(n, dtype=np.uint8)], axis=1)
        for col in range(n):
            piv = next((r for r in range(col, n) if aug[r, col]), None)
            if piv is None:
                raise ValueError("singular GF(2^8) matrix")
            aug[[col, piv]] = aug[[piv, col]]
            aug[col] = self.mul[self.inv[aug[col, col]]][aug[col]]
            for r in range(n):
                if r != col and aug[r, col]:
                    aug[r] ^= self.mul[aug[r, col]][aug[col]]
        return aug[:, n:].copy()

    def cauchy(self, k: int, m: int) -> np.ndarray:
        """Systematic (k+m, k) generator: the identity over the Cauchy
        block C[i, j] = 1 / ((k+i) ^ j) (ISA-L's gf_gen_cauchy1_matrix
        and jerasure's cauchy_orig)."""
        g = np.zeros((k + m, k), dtype=np.uint8)
        g[:k] = np.eye(k, dtype=np.uint8)
        for i in range(m):
            for j in range(k):
                g[k + i, j] = self.inv[(k + i) ^ j]
        return g

    def vandermonde(self, k: int, m: int) -> np.ndarray:
        """Systematic (k+m, k) generator from the Vandermonde matrix
        V[i, j] = i^j (0^0 = 1), column-reduced so that its top k rows
        are the identity: V inv(V[:k])."""
        v = np.zeros((k + m, k), dtype=np.uint8)
        for i in range(k + m):
            p = 1
            for j in range(k):
                v[i, j] = p
                p = int(self.mul[p, i])
        return self.matmul(v, self.invert(v[:k]))

    def generator(self, technique: str, k: int, m: int) -> np.ndarray:
        if technique == "cauchy":
            return self.cauchy(k, m)
        if technique == "reed_sol_van":
            return self.vandermonde(k, m)
        raise ValueError(f"the reference implements the techniques "
                         f"{TECHNIQUES}, not {technique!r}")

    def recovery(self, gen: np.ndarray, k: int, survivors, targets
                 ) -> np.ndarray:
        """(len(targets), k) coefficients that rebuild `targets` from
        the k `survivors` rows of the generator."""
        inv = self.invert(gen[list(survivors)])
        return self.matmul(gen[list(targets)], inv)


@functools.lru_cache(maxsize=8)
def field(poly: int = STATED_POLY) -> Field:
    return Field(poly)


@functools.lru_cache(maxsize=8)
def _mul_tensor(poly: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(field(poly).mul.copy()).to(device)


def mul(poly: int, c: int, x: torch.Tensor) -> torch.Tensor:
    """c * x elementwise over GF(2^8)/poly, x a uint8 tensor."""
    if c == 0:
        return torch.zeros_like(x)
    if c == 1:
        return x.clone()
    row = _mul_tensor(poly, x.device)[int(c)]
    return row[x.long()]


def apply(poly: int, coeff: np.ndarray, rows: torch.Tensor,
          block: int = 1 << 22) -> torch.Tensor:
    """(r, k) coefficients x (k, N) uint8 rows -> (r, N): out[i] = XOR
    over j of coeff[i, j] * rows[j], `block` columns at a time."""
    coeff = np.asarray(coeff, dtype=np.uint8)
    table = _mul_tensor(poly, rows.device)
    out = torch.zeros((coeff.shape[0], rows.shape[1]), dtype=torch.uint8,
                      device=rows.device)
    for c0 in range(0, rows.shape[1], block):
        idx = rows[:, c0:c0 + block].long()
        for i in range(coeff.shape[0]):
            acc = out[i, c0:c0 + block]
            for j in range(coeff.shape[1]):
                c = int(coeff[i, j])
                if c:
                    acc ^= table[c][idx[j]]
    return out

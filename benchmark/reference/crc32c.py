"""crc32c (Castagnoli, reflected polynomial 0x82f63b78), in NumPy and
plain PyTorch.

`update(crc, data)` is Ceph's convention (ceph_crc32c, HashInfo): the
caller's seed, no final xor.  `crc32c(data)` is the standard check
function (seed and final xor 0xffffffff).  The crc is linear over GF(2)
in (seed, bytes): crc(seed, B) = A_|B| seed ^ crc(0, B), with A_n the
operator that advances a state over n zero bytes, kept as its 32
columns.  `rows_linear` walks many byte rows at once on their device,
each row cut into pieces that are folded with those operators.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x82F63B78


@functools.lru_cache(maxsize=1)
def table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        t[i] = c
    return t


def update(crc: int, data) -> int:
    """Ceph's crc32c: seed `crc`, no final xor."""
    t = table()
    crc &= 0xFFFFFFFF
    for b in bytes(data):
        crc = int(t[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc


def crc32c(data) -> int:
    """The standard crc32c of `data` (0xe3069283 for b"123456789")."""
    return update(0xFFFFFFFF, data) ^ 0xFFFFFFFF


def _apply(op: tuple[int, ...], state: int) -> int:
    acc = 0
    b = 0
    while state:
        if state & 1:
            acc ^= op[b]
        state >>= 1
        b += 1
    return acc


@functools.lru_cache(maxsize=64)
def _pow2_op(j: int) -> tuple[int, ...]:
    """The operator that advances a state over 2**j zero bytes."""
    if j == 0:
        t = table()
        return tuple(int(t[(1 << b) & 0xFF]) ^ ((1 << b) >> 8)
                     for b in range(32))
    half = _pow2_op(j - 1)
    return tuple(_apply(half, c) for c in half)


@functools.lru_cache(maxsize=256)
def advance_op(nbytes: int) -> tuple[int, ...]:
    op = tuple(1 << b for b in range(32))
    j = 0
    while nbytes:
        if nbytes & 1:
            step = _pow2_op(j)
            op = tuple(_apply(step, c) for c in op)
        nbytes >>= 1
        j += 1
    return op


def zeros(crc: int, nbytes: int) -> int:
    """Advance `crc` over `nbytes` zero bytes."""
    return _apply(advance_op(nbytes), crc & 0xFFFFFFFF)


def _apply_tensor(op: tuple[int, ...], state: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(state)
    for b in range(32):
        out ^= ((state >> b) & 1) * op[b]
    return out


def rows_linear(rows: torch.Tensor, piece: int = 1024) -> torch.Tensor:
    """crc(0, row) of every row of an (R, n) uint8 tensor, as (R,)
    int64, on the rows' device.  Each row is front-padded with zeros
    (which leave the value unchanged) to a power-of-two count of
    `piece`-byte pieces; every piece walks the byte table, and the
    pieces fold pairwise with the advance operators."""
    r, n = rows.shape
    dev = rows.device
    if n == 0:
        return torch.zeros(r, dtype=torch.int64, device=dev)
    npieces = 1
    while npieces * piece < n:
        npieces *= 2
    pad = npieces * piece - n
    if pad:
        rows = torch.cat([torch.zeros((r, pad), dtype=torch.uint8,
                                      device=dev), rows], dim=1)
    cols = rows.reshape(r * npieces, piece).t().contiguous().long()
    t = torch.from_numpy(table().astype(np.int64)).to(dev)
    c = torch.zeros(r * npieces, dtype=torch.int64, device=dev)
    for col in cols:
        c = t[(c ^ col) & 0xFF] ^ (c >> 8)
    c = c.reshape(r, npieces)
    size = piece
    while c.shape[1] > 1:
        c = _apply_tensor(advance_op(size), c[:, 0::2]) ^ c[:, 1::2]
        size *= 2
    return c[:, 0]


def rows_crc(rows: torch.Tensor, seeds) -> list[int]:
    """Ceph crc32c of every row, row i seeded seeds[i]."""
    lin = rows_linear(rows).tolist()
    n = rows.shape[1]
    return [zeros(int(s), n) ^ int(v) for s, v in zip(seeds, lin)]

"""crc32c as GF(2) linear algebra, in PyTorch.

The crc32c byte update  crc' = (crc >> 8) ^ T[(crc ^ b) & 0xff]  is
GF(2)-linear in (crc, b).  Hence for an N-byte block B,

    crc(B, seed) = A_N . seed  (+)  L(B)

with A_N the 32x32 zero-advance matrix and the linear part L(B) =
crc(B, 0) a GF(2)-linear map of B's bits: L(B) = C_N @ bits(B) mod 2.
Blocks fold with  L(B1||B2) = A_{|B2|} L(B1) + L(B2).

This module holds the host-built matrices (numpy; vectorised code
whose outputs equal the JAX package's loops) and the PyTorch
functions over 0/1 bit tensors.  The bit tensors ride float32 matmuls:
PyTorch has no integer matmul on CUDA, and 0/1 sums stay exact in
float32 up to 2^24 (the deepest contraction here is 32*512 = 16384).
The CUDA kernels (csrc/gf_encode_crc.cu) compute the same L-vectors
with a byte table and the A operators instead; the functions here are
their plain versions and the device-side combine of the extents path.

Matches `bufferlist::crc32c` exactly (Castagnoli, caller seed, no
final xor).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..common import crc32c as _crc
from ..common.util import next_pow2


def _op_bits(op: np.ndarray) -> np.ndarray:
    """32 uint32 operator columns -> (32, 32) int8, row j = bits of
    A . e_j (the layout of crc_advance_matrix)."""
    return ((op[:, None] >> np.arange(32, dtype=np.uint32)) & 1) \
        .astype(np.int8)


@functools.lru_cache(maxsize=8)
def crc_tile_matrix(tile: int) -> np.ndarray:
    """(8*tile, 32) int8: row [i*tile + t] = bits of L(block with only
    bit i of byte t set).  Byte t of a `tile`-byte block is followed by
    tile-1-t bytes, so its contribution is A_{tile-1-t} . L1(bit)."""
    t = _crc._sw_table()
    cur = t[np.uint32(1) << np.arange(8, dtype=np.uint32)]  # L1 of bit i
    out = np.zeros((8, tile), dtype=np.uint32)
    mask, eight = np.uint32(0xFF), np.uint32(8)
    for pos in range(tile - 1, -1, -1):
        out[:, pos] = cur
        cur = t[cur & mask] ^ (cur >> eight)    # advance one zero byte
    bits = (out[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.astype(np.int8).reshape(8 * tile, 32)


@functools.lru_cache(maxsize=8)
def crc_tile_matrix_w32(wt: int) -> np.ndarray:
    """(32*wt, 32) int8 for little-endian 32-bit words: rows [i*wt + t]
    = L-contribution of word-bit i at word position t (word bit i is
    bit i%8 of byte 4t + i//8)."""
    base = crc_tile_matrix(4 * wt).reshape(8, 4 * wt, 32)
    out = np.zeros((32, wt, 32), dtype=np.int8)
    for i in range(32):
        out[i] = base[i % 8, (i // 8)::4, :]
    return out.reshape(32 * wt, 32)


@functools.lru_cache(maxsize=16)
def crc_advance_matrix(nbytes: int) -> np.ndarray:
    """(32, 32) int8: row j = bits of A_{nbytes} e_j, so advancing an
    L-vector over `nbytes` zero bytes is `lbits @ this` (mod 2)."""
    return _op_bits(_crc.advance_op(nbytes))


@functools.lru_cache(maxsize=8)
def crc_combine_matrix(s: int, block_bytes: int) -> np.ndarray:
    """(s*32, 32) int8: row [si*32 + j] = bits of
    A^{block_bytes*(s-1-si)} e_j, so L(B_0||...||B_{s-1}) =
    [L(B_0)..L(B_{s-1})] (flattened, 32 bits each) @ this (mod 2)."""
    return np.concatenate([crc_advance_matrix(block_bytes * (s - 1 - si))
                           for si in range(s)], axis=0)


def _matmul_mod2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0/1 float32 matmul reduced mod 2, as int32."""
    return torch.matmul(a, b).to(torch.int32) & 1


def subblock_crc_bits_w32(words: torch.Tensor, cmat_sub: torch.Tensor,
                          wb: int) -> torch.Tensor:
    """words (r, Wt) int32 little-endian packed bytes; cmat_sub
    (32*wb, 32) from crc_tile_matrix_w32(wb).  Returns (r*S, 32) int32
    0/1 with S = Wt // wb: row r'*S + si = L-bits of shard r''s si-th
    wb-word sub-block (the per-sub-block output of Pallas kernel #1)."""
    r, wt = words.shape
    s = wt // wb
    w2 = words.reshape(r * s, wb)
    cm = cmat_sub.to(device=words.device, dtype=torch.float32)
    acc = torch.zeros((r * s, 32), dtype=torch.float32, device=words.device)
    for i in range(32):
        plane = ((w2 >> i) & 1).to(torch.float32)
        acc += plane @ cm[i * wb:(i + 1) * wb]
    return acc.to(torch.int32) & 1


def tile_crc_bits_w32(words: torch.Tensor,
                      cmat32: torch.Tensor) -> torch.Tensor:
    """words (r, Wt) int32 (one tile per row); cmat32 (32*Wt, 32) from
    crc_tile_matrix_w32(Wt) -> (r, 32) int32 0/1 L-bits per row."""
    return subblock_crc_bits_w32(words, cmat32, words.shape[1])


@functools.lru_cache(maxsize=64)
def _pair_matrix(block_bytes: int, device: torch.device) -> torch.Tensor:
    """crc_combine_matrix(2, block_bytes) as float32 on `device`, cached:
    a fresh host-to-device copy per call would synchronise the stream
    and stall the dispatch-ahead pipeline."""
    return torch.from_numpy(crc_combine_matrix(2, block_bytes)).to(
        device=device, dtype=torch.float32)


def combine_crcs_pow2(lbits: torch.Tensor, block_bytes: int) -> torch.Tensor:
    """Log-depth GF(2) combine of per-block L-vectors into one L per
    shard.  lbits (r, T, 32) 0/1, block t of shard r' in time order.
    Returns (r, 32) int32 0/1 = L(B_0||...||B_{T-1}).

    The block count is front-padded with zero blocks to a power of two
    (L(0^n || B) = L(B): a zero PREFIX never changes L), then each
    level pairs adjacent blocks with one (., 64) x (64, 32) matmul
    against crc_combine_matrix(2, bytes) and doubles the block size."""
    r, t, _ = lbits.shape
    dev = lbits.device
    if t == 0:
        return torch.zeros((r, 32), dtype=torch.int32, device=dev)
    lb = lbits.to(torch.float32)
    t2 = next_pow2(t)
    if t2 != t:
        lb = torch.cat([torch.zeros((r, t2 - t, 32), dtype=lb.dtype,
                                    device=dev), lb], dim=1)
    bb = block_bytes
    while t2 > 1:
        pairs = lb.reshape(r * (t2 // 2), 64)   # [left 32 | right 32]
        lb = _matmul_mod2(pairs, _pair_matrix(bb, dev)).to(torch.float32) \
            .reshape(r, t2 // 2, 32)
        t2 //= 2
        bb *= 2
    return lb[:, 0].to(torch.int32)


def combine_subblock_crcs(lsub: torch.Tensor, combine: torch.Tensor,
                          r: int, s: int) -> torch.Tensor:
    """Level 2: per-sub-block L-vectors (ntiles*r*s, 32), row-major
    [tile, shard, sub], folded into per-tile L-vectors (ntiles, r, 32)
    with combine = crc_combine_matrix(s, sub_block_bytes)."""
    ntiles = lsub.shape[0] // (r * s)
    l2 = lsub.reshape(ntiles * r, s * 32).to(torch.float32)
    cm = combine.to(device=lsub.device, dtype=torch.float32)
    return _matmul_mod2(l2, cm).reshape(ntiles, r, 32)


def bits_to_u32(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 -> (...,) int64 holding the uint32 value (bit j has
    weight 2^j).  int64 because torch's uint32 support is partial."""
    w = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    return (bits.to(torch.int64) * w).sum(dim=-1)


def u32_to_bits(vals: torch.Tensor) -> torch.Tensor:
    """(...,) integer tensor of uint32 values -> (..., 32) int32 0/1."""
    v = vals.to(torch.int64)
    return ((v[..., None] >> torch.arange(32, device=v.device)) & 1) \
        .to(torch.int32)


def fold_run_crc(lbody: int, body_bytes: int, seed: int,
                 tail: bytes = b"") -> int:
    """O(1) host fold of one run: the device-combined body L plus an
    optional sub-block tail, re-seeded.  crc = A_{n}(seed) ^
    (A_{|tail|}(L_body) ^ L(tail)) — one seed-advance per extent."""
    acc = int(lbody) & 0xFFFFFFFF
    n = body_bytes
    if tail:
        acc = _crc.crc32c_zeros(acc, len(tail)) ^ _crc.crc32c(tail, 0)
        n += len(tail)
    return _crc.crc32c_zeros(seed & 0xFFFFFFFF, n) ^ acc


SCRUB_BLOCK = 2048       # bytes per L-block of the scrub rows path


def crc32c_rows_device(row_list, seeds, block_bytes: int = SCRUB_BLOCK,
                       device="cuda") -> list[int]:
    """crc32c of many independent byte rows of different lengths, with
    one K5 launch for all of them (ops/bitsliced.crc32c_rows_l) — the
    deep-scrub verify path (osd/scrub.py), the JAX package's
    crc32c_rows_device.

    Each row splits into a body of whole `block_bytes` blocks and a
    tail.  The bodies are gathered end to end into one pinned staging
    buffer and go to the device; the host folds each row's seed advance
    and tail (fold_run_crc), so the device/host byte split is the
    reference's.  Unlike the reference, the bodies are not front-padded
    to pow2 buckets with one launch a bucket: nothing here compiles per
    width, so one launch takes the rows at their real widths.  No row
    with a body, no launch.  `device="cpu"` runs K5's plain version."""
    from .. import resolve_device
    from . import bitsliced as bs
    dev = resolve_device(device)
    rows = [np.ascontiguousarray(r, dtype=np.uint8).ravel()
            for r in row_list]
    bodies = [r.size - r.size % block_bytes for r in rows]
    ls = [0] * len(rows)
    if any(bodies):
        # the pinned buffers stay referenced until .tolist() has waited
        # for the stream
        staged, data = bs.stage([r[:b] for r, b in zip(rows, bodies)], dev)
        staged_ends, row_ends = bs._rows_launch_args(
            [b // block_bytes for b in bodies], sum(bodies) // block_bytes,
            dev)
        ls = bs.crc32c_rows_l(data, row_ends, block_bytes).tolist()
    return [fold_run_crc(ls[i], bodies[i], int(seeds[i]),
                         rows[i][bodies[i]:].tobytes())
            for i in range(len(rows))]


def crc32c_rows_plain(row_list, seeds,
                      block_bytes: int = SCRUB_BLOCK) -> list[int]:
    """crc32c_rows_device on K5's plain version (the CPU)."""
    return crc32c_rows_device(row_list, seeds, block_bytes, device="cpu")

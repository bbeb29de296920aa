"""GF(2^8) parity and fused parity+crc32c on the card: kernel wrappers,
their plain PyTorch versions, and the multi-extent launch contract.

Four hand-written CUDA kernels (csrc/) carry the EC data plane:

* K1 `gf_bitmatmul` (csrc/gf_bitmatmul.cu) — out = C x data over
  GF(2^8) for an (r, k) coefficient matrix.  Replaces Pallas kernel #3
  (`_make_gf_kernel_w32`, ceph_tpu/ops/bitsliced.py:227) and its byte
  twin #5 (`_gf_kernel` :122, the device-resident entries of the
  plugin).  Serves every decode and the plain encode of overwrite
  extents.  On the H100 the shared-memory lookups' bank wavefronts bound
  it at wide rows and launch plus table staging at narrow ones; so one
  32-bit lookup of a packed table serves four output rows of an input
  byte, and the grid follows the width: `k1_launch` (4 or 16 bytes of
  each row a thread, at most one resident wave of blocks) and `k1_smem`
  (the packed tables' shared-memory layout) are the pure functions the
  wrapper passes in.
* K2 `gf_encode_crc` (csrc/gf_encode_crc_acc.cu, entry
  ctt_gf_encode_crc) — parity plus the crc32c linear part L of every
  block of all k+m shard rows, one launch.  Three entries with the
  contracts of Pallas kernels #1, #2 and #6: `fused_hier_call` (L per
  4*wb-byte sub-block, ceph_tpu's `_fused_hier_call` :586),
  `gf_encode_with_crc_w32` (L per tile, ceph_tpu's
  `gf_encode_with_crc_pallas_w32` :459) and `gf_encode_with_crc` (the
  same on the byte layout, ceph_tpu's `gf_encode_with_crc_pallas` :411;
  the write path's "bytes" branch).
* K3 `gf_encode_crc_acc` (csrc/gf_encode_crc_acc.cu) — parity plus ONE
  L per (run, shard) of a drain's front-padded runs, one launch: the
  contract of Pallas kernel #4 (`_fused_hier_acc_call` :626), entry
  `fused_hier_acc_call`.  The write path's `combine="kernel"` point.
  K2 and K3 share one per-block body: packed parity by nibble tables, a
  crc table copy per lane with four interleaved chains and a fold of
  one nibble-table matvec a lane; K3 then advances each block's L by
  base-256 digits to its run's end, K2 writes it.  `k3_smem` and
  `_crc_smem_bytes` (layouts; `k2_lane_tables` K2's branch by shape),
  `k3_launch` (grid) and `k3_ops` (the operators) are the host's pure
  mirrors.
* K4 `gf_bitmatmul_stream` (csrc/gf_bitmatmul_stream.cu) — K1's
  function with the contraction (the k source rows) split into passes
  whose packed tables fit one block, the partials XOR-accumulated in
  the block's own output columns: the counterpart of Pallas kernel #7
  (`_make_gf_kernel_w32_stream` :245, reached through
  `gf_bitmatmul_pallas_w32(stream=True)`).  It serves the matrices K1
  refuses, the CLAY repair matrices of parallel/mesh.ClayRepairPlan
  (64 x 176, 81 x 270), and the tools/w32_sweep path; `k4_plan` is its
  launch's pure mirror.

The coefficient operand of every kernel is the (r, k, 256) product
table of the matrix (ec/gf.product_tables).  The kernels take bytes:
the TPU kernels' int32 word packing, sublane bitcasts and expanded
(32r, 32k) bit-matrices were Mosaic artifacts, and the outputs here are
the same values in plain layout (parity bytes; L as uint32 values,
returned as int64 tensors because torch's uint32 support is partial).

A wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors — only because the tensors lie on the CPU;
there is no fallback from a failed build or launch.  Each wrapper
counts its kernel launches in a plain integer attribute (`.launches`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import crc32c_linear as cl

FUSED_TILE = 2048            # flat fused path: bytes per crc tile
FUSED_WB = 512               # hier path: sub-block, words (2 KiB)
FUSED_TILE_HIER = 131072     # runs at least this wide take the hier entry
SMEM_LIMIT = 232448          # bytes of shared memory a block may use


# ----------------------------------------------------------------------------
# operands
# ----------------------------------------------------------------------------

def tables_tensor(tables: np.ndarray, device: torch.device) -> torch.Tensor:
    """(r, k, 256) uint8 product tables (ec/gf.product_tables) as the
    kernels' coefficient operand on `device`."""
    t = np.ascontiguousarray(tables, dtype=np.uint8)
    if t.ndim != 3 or t.shape[2] != 256:
        raise ValueError(f"product tables must be (r, k, 256), got {t.shape}")
    return torch.from_numpy(t.copy()).to(device)


def _bitmatrix_from_tables(tables: torch.Tensor) -> torch.Tensor:
    """(r, k, 256) product tables -> interleaved (8r, 8k) float32 0/1
    bit-matrix: out[i*r + ri, j*k + cj] = bit i of c*2^j with c =
    coefficient (ri, cj), i.e. column j of its 8x8 bit-matrix."""
    r, k, _ = tables.shape
    dev = tables.device
    prods = tables[:, :, [1 << j for j in range(8)]].to(torch.int32)
    bits = (prods[..., None] >> torch.arange(8, device=dev)) & 1  # r,k,j,i
    return bits.permute(3, 0, 2, 1).reshape(8 * r, 8 * k) \
        .to(torch.float32)


def _check(name: str, t, device: torch.device, dtype: torch.dtype,
           ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned on the device")


def _check_operands(tables, chunks) -> tuple[int, int, int]:
    if not isinstance(tables, torch.Tensor):
        raise TypeError("tables must be a torch.Tensor")
    _check("tables", tables, tables.device, torch.uint8, 3)
    _check("chunks", chunks, tables.device, torch.uint8, 2)
    r, k, w = tables.shape
    if w != 256:
        raise ValueError(f"tables must be (r, k, 256), got {tuple(tables.shape)}")
    if chunks.shape[0] != k:
        raise ValueError(f"chunks have {chunks.shape[0]} rows, tables "
                         f"expect k={k}")
    return r, k, chunks.shape[1]


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------------
# K1: GF(2^8) matrix apply
# ----------------------------------------------------------------------------

def gf_bitmatmul_plain(tables: torch.Tensor,
                       chunks: torch.Tensor) -> torch.Tensor:
    """Plain version of K1, the bit-plane form of ceph_tpu's
    gf_bitmatmul_xla: unpack the k rows to 8k 0/1 planes (bit-major,
    row i*k + j = bit i of chunk j), one float32 matmul with the
    interleaved bit-matrix, mod 2, pack."""
    r, k, _ = tables.shape
    n = chunks.shape[1]
    dev = chunks.device
    shifts = torch.arange(8, device=dev, dtype=torch.int32)[:, None, None]
    bits = ((chunks.to(torch.int32)[None] >> shifts) & 1) \
        .to(torch.float32).reshape(8 * k, n)
    prod = (_bitmatrix_from_tables(tables) @ bits).to(torch.int32) & 1
    out = torch.zeros((r, n), dtype=torch.int32, device=dev)
    for i in range(8):
        out |= prod[i * r:(i + 1) * r] << i
    return out.to(torch.uint8)


def _check_tile(tile: int | None, n: int) -> int:
    """The launch's bytes of each row per thread block (0 = the
    kernel's own grid-stride launch)."""
    if tile is None:
        return 0
    if tile <= 0 or tile % 16:
        raise ValueError(f"tile must be a positive multiple of 16, got {tile}")
    if -(-n // tile) >= 1 << 31:
        raise ValueError(f"tile {tile} gives too many blocks for width {n}")
    return tile


def k1_tables_fit(r: int, k: int) -> bool:
    """Whether K1 takes (r, k) product tables: their r*k*256 bytes fit
    the shared memory of one block.  K4 serves the rest."""
    return r * k * 256 <= SMEM_LIMIT


def _check_tables_smem(name: str, r: int, k: int) -> None:
    if not k1_tables_fit(r, k):
        raise ValueError(f"{name}: {r}x{k} product tables exceed the "
                         "shared memory of one block")


K1_THREADS = 256             # threads of a K1 block
# 16 bytes a thread from this many bytes of each row an SM (3 KiB, 3/4
# of a block of 16-byte threads): on the H100 16 bytes lose at 256 KiB a
# row (2 KiB an SM) and win at 512 KiB (chip_smoke.py's k1_thread_bytes
# table, PERF.md)
K1_WIDE_ROW_BYTES_PER_SM = 3 << 10
# resident K1 blocks an SM by registers, by bytes a thread: the launch
# bounds of csrc/gf_bitmatmul.cu guarantee them
K1_BLOCKS_PER_SM = {4: 4, 16: 2}
SM_SMEM = 233472             # shared memory of one SM (228 KiB)
BLOCK_SMEM_RESERVED = 1024   # shared memory the card keeps for each block


@functools.lru_cache(maxsize=1024)
def k1_smem(r: int, k: int) -> tuple[int, int]:
    """K1's shared-memory layout for r output and k source rows: (groups
    of four rows whose packed tables one pass stages, bytes).  A group's
    packed table takes k KiB: all ceil(r/4) groups at once where they fit
    in one block, else one group a pass, else (k > 227) 0 — the loop
    over the r*k*256 byte tables.  Raises ValueError where the byte
    tables alone would not fit: r*k*256 > SMEM_LIMIT."""
    _check_tables_smem("gf_bitmatmul", r, k)
    groups = -(-r // 4)
    if groups * k * 1024 <= SMEM_LIMIT:
        return groups, groups * k * 1024
    if k * 1024 <= SMEM_LIMIT:
        return 1, k * 1024
    return 0, r * k * 256


@functools.lru_cache(maxsize=1024)
def k1_launch(n: int, k: int, r: int, sm_count: int, tile: int | None = None,
              thread_bytes: int | None = None) -> tuple[int, int]:
    """K1's launch for a width of n bytes a row: (bytes of every row a
    thread takes, blocks of K1_THREADS).  A thread takes 16 bytes where
    the row gives K1_WIDE_ROW_BYTES_PER_SM bytes an SM and is 16-byte
    aligned (n % 16 == 0), else 4; `thread_bytes` forces the choice.
    With a `tile` (bytes of each row per block) the grid is
    ceil(n / tile) blocks; without, enough blocks for every thread-width
    of the row, at most one wave (sm_count times the blocks an SM holds
    by registers and shared memory), the blocks striding over the rest."""
    if thread_bytes is None:
        wide = n % 16 == 0 and n >= K1_WIDE_ROW_BYTES_PER_SM * sm_count
        thread_bytes = 16 if wide else 4
    if thread_bytes not in (4, 16):
        raise ValueError(f"thread_bytes must be 4 or 16, got {thread_bytes}")
    if tile:
        return thread_bytes, max(1, -(-n // tile))
    smem = k1_smem(r, k)[1] + BLOCK_SMEM_RESERVED
    per_sm = min(K1_BLOCKS_PER_SM[thread_bytes], SM_SMEM // smem)
    blocks = -(-n // (thread_bytes * K1_THREADS))
    return thread_bytes, max(1, min(blocks, per_sm * sm_count))


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gf_bitmatmul(tables: torch.Tensor, chunks: torch.Tensor,
                 tile: int | None = None,
                 thread_bytes: int | None = None) -> torch.Tensor:
    """K1: (r, k, 256) product tables x (k, N) uint8 chunks -> (r, N)
    uint8.  CUDA tensors launch csrc/gf_bitmatmul.cu with k1_launch's
    grid; CPU tensors run gf_bitmatmul_plain.  `tile` (bytes of each row
    per thread block, a multiple of 16) sets a grid of ceil(N / tile)
    blocks (tools/w32_sweep sweeps it); `thread_bytes` (4 or 16) forces
    the bytes of each row a thread takes, which k1_launch otherwise
    picks from the width."""
    r, k, n = _check_operands(tables, chunks)
    tile_b = _check_tile(tile, n)
    if thread_bytes not in (None, 4, 16):
        raise ValueError(f"thread_bytes must be 4 or 16, got {thread_bytes}")
    dev = chunks.device
    if dev.type == "cpu":
        return gf_bitmatmul_plain(tables, chunks)
    stage_groups, _ = k1_smem(r, k)
    out = torch.empty((r, n), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    tb, blocks = k1_launch(n, k, r, _sm_count(dev), tile_b, thread_bytes)
    from . import _build
    lib = _build.load()
    rc = lib.ctt_gf_bitmatmul(tables.data_ptr(), chunks.data_ptr(),
                              out.data_ptr(), r, k, n, tile_b, tb, blocks,
                              stage_groups, _stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"gf_bitmatmul launch failed: CUDA error {rc}")
    gf_bitmatmul.launches += 1
    return out


gf_bitmatmul.launches = 0


# ----------------------------------------------------------------------------
# K4: GF(2^8) matrix apply with the contraction split into passes
# ----------------------------------------------------------------------------

K4_THREADS = 256             # threads of a K4 block (K1's)
K4_TABLE_BYTES_PER_ROW = 1024  # a group's packed table, per source row
K4_MAX_GROUP_BLOCKS = 65535  # the grid's y extent


class K4Plan(NamedTuple):
    """K4's launch (csrc/gf_bitmatmul_stream.cu): bytes of each row a
    thread takes, groups of four output rows a block owns, source rows a
    pass, passes, blocks along the groups and along the columns, and the
    block's shared memory (its groups' packed tables of one pass)."""
    thread_bytes: int
    groups_per_block: int
    rows_per_pass: int
    passes: int
    group_blocks: int
    col_blocks: int
    smem: int


def stream_groups(k: int) -> int:
    """K4's default passes for k source rows (the `groups` of #7's grid):
    the fewest whose one group's packed tables fit one block, ceil(k /
    227) — one pass up to k = 227, two at the CLAY repair matrix of k=8
    m=3 d=10 (k = 270)."""
    return max(1, -(-k // (SMEM_LIMIT // K4_TABLE_BYTES_PER_ROW)))


def _pass_rows(k: int, groups: int | None) -> int:
    """Source rows a pass for `groups` passes (default stream_groups(k)):
    ceil(k / groups), the passes contiguous and the last one shorter.
    More passes than rows give one row a pass."""
    g = stream_groups(k) if groups is None else groups
    if isinstance(g, bool) or not isinstance(g, (int, np.integer)) or g < 1:
        raise ValueError(f"groups (passes) must be a positive integer, "
                         f"got {g!r}")
    rows = max(1, -(-k // int(g)))
    if rows * K4_TABLE_BYTES_PER_ROW > SMEM_LIMIT:
        raise ValueError(f"{g} passes of {rows} source rows: one group's "
                         "packed tables exceed the shared memory of one "
                         "block")
    return rows


@functools.lru_cache(maxsize=1024)
def k4_plan(r: int, k: int, n: int, sms: int, tile: int | None = None,
            passes: int | None = None) -> K4Plan:
    """K4's launch for (r, k) tables over n bytes a row, the host's pure
    mirror of the kernel's layout.  Passes of _pass_rows(k, passes)
    source rows; a block owns as many groups as fit one pass's tables in
    one block (all ceil(r/4) where they fit: K1's layout).  A thread
    takes 16 bytes where the row is 16-byte aligned and the blocks along
    the groups give K1_WIDE_ROW_BYTES_PER_SM bytes an SM (K1's rule,
    counted over every group block), else 4.  With a `tile` (bytes of
    each row per block) the columns take ceil(n / tile) blocks; without,
    enough for every thread-width of the row, at most what leaves one
    resident wave (sm count times the blocks an SM holds by registers
    and shared memory) to the group blocks, the blocks striding over the
    rest."""
    if r < 1 or k < 1 or n < 1:
        raise ValueError(f"k4_plan needs r, k, n >= 1, got {(r, k, n)}")
    rows = _pass_rows(k, passes)
    groups = -(-r // 4)
    table = rows * K4_TABLE_BYTES_PER_ROW
    gpb = min(groups, SMEM_LIMIT // table)
    group_blocks = -(-groups // gpb)
    if group_blocks > K4_MAX_GROUP_BLOCKS:
        raise ValueError(f"{r} output rows need {group_blocks} group blocks "
                         f"(at most {K4_MAX_GROUP_BLOCKS})")
    smem = gpb * table
    wide = n % 16 == 0 and n * group_blocks >= K1_WIDE_ROW_BYTES_PER_SM * sms
    tb = 16 if wide else 4
    if tile:
        col_blocks = -(-n // tile)
    else:
        per_sm = min(K1_BLOCKS_PER_SM[tb],
                     SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
        need = -(-n // (tb * K4_THREADS))
        col_blocks = max(1, min(need, per_sm * sms // group_blocks))
    return K4Plan(tb, gpb, rows, -(-k // rows), group_blocks, col_blocks,
                  smem)


def gf_bitmatmul_stream_plain(tables: torch.Tensor, chunks: torch.Tensor,
                              groups: int | None = None) -> torch.Tensor:
    """Plain version of K4, in #7's grid order: the partial of each pass
    (contiguous source rows, _pass_rows(k, groups) of them) by K1's plain
    version, XOR-accumulated into the output one pass after another —
    another order than K1's plain version, which contracts all rows at
    once."""
    r, k, _ = tables.shape
    rows = _pass_rows(k, groups)
    out = torch.zeros((r, chunks.shape[1]), dtype=torch.uint8,
                      device=chunks.device)
    for jb in range(0, k, rows):
        out ^= gf_bitmatmul_plain(tables[:, jb:jb + rows].contiguous(),
                                  chunks[jb:jb + rows].contiguous())
    return out


def gf_bitmatmul_stream(tables: torch.Tensor, chunks: torch.Tensor,
                        tile: int | None = None,
                        groups: int | None = None) -> torch.Tensor:
    """K4: K1's function, (r, k, 256) tables x (k, N) uint8 chunks ->
    (r, N) uint8, with the k-row contraction split into `groups` passes
    (#7's plane groups; default stream_groups(k), the fewest that fit)
    whose partials are XOR-accumulated in the output.  The counterpart
    of ceph_tpu's gf_bitmatmul_pallas_w32(stream=True); serves every r
    and k — the CLAY repair matrices K1 refuses — and every width,
    ragged too.  `tile` as for K1.  CUDA tensors launch
    csrc/gf_bitmatmul_stream.cu with k4_plan's grid; CPU tensors run
    gf_bitmatmul_stream_plain."""
    r, k, n = _check_operands(tables, chunks)
    tile_b = _check_tile(tile, n)
    _pass_rows(k, groups)
    dev = chunks.device
    if dev.type == "cpu":
        return gf_bitmatmul_stream_plain(tables, chunks, groups)
    out = torch.empty((r, n), dtype=torch.uint8, device=dev)
    if n == 0 or r == 0:
        return out
    plan = k4_plan(r, k, n, _sm_count(dev), tile_b or None, groups)
    from . import _build
    lib = _build.load()
    rc = lib.ctt_gf_bitmatmul_stream(
        tables.data_ptr(), chunks.data_ptr(), out.data_ptr(), r, k, n,
        tile_b, plan.thread_bytes, plan.groups_per_block,
        plan.rows_per_pass, plan.col_blocks, _stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"gf_bitmatmul_stream launch failed: CUDA error "
                           f"{rc}")
    gf_bitmatmul_stream.launches += 1
    return out


gf_bitmatmul_stream.launches = 0


# ----------------------------------------------------------------------------
# K2: fused parity + per-block crc32c L
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _cmat_w32(wt: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cl.crc_tile_matrix_w32(wt)).to(
        device=device, dtype=torch.float32)


def _block_ls_plain(allsh: torch.Tensor, block: int) -> torch.Tensor:
    """(R, N) uint8 shard rows -> (R, N // block) int64 L-values, via
    the crc matrix of 4-byte words (tile_crc_bits_w32 over every
    block)."""
    r, n = allsh.shape
    wt = block // 4
    nb = n // block
    words = allsh.contiguous().view(torch.int32).reshape(r * nb, wt)
    bits = cl.tile_crc_bits_w32(words, _cmat_w32(wt, allsh.device))
    return cl.bits_to_u32(bits).reshape(r, nb)


def fused_hier_call_plain(tables: torch.Tensor, chunks: torch.Tensor,
                          wb: int = FUSED_WB):
    """Plain version of the hier entry: K1's plain parity, then the
    per-sub-block L of all k+m rows with subblock_crc_bits_w32 (the
    level-1 crc of Pallas kernel #1)."""
    r_tot = tables.shape[0] + tables.shape[1]
    parity = gf_bitmatmul_plain(tables, chunks)
    allsh = torch.cat([chunks, parity], dim=0)
    words = allsh.view(torch.int32)
    lsub = cl.subblock_crc_bits_w32(words, _cmat_w32(wb, chunks.device), wb)
    return parity, cl.bits_to_u32(lsub).reshape(r_tot, -1)


def gf_encode_with_crc_w32_plain(tables: torch.Tensor, chunks: torch.Tensor,
                                 tile: int = FUSED_TILE):
    """Plain version of the flat entry: K1's plain parity, then one L
    per `tile` bytes of all k+m rows (tile_crc_bits_w32 per tile, the
    crc of Pallas kernel #2)."""
    parity = gf_bitmatmul_plain(tables, chunks)
    allsh = torch.cat([chunks, parity], dim=0)
    return parity, _block_ls_plain(allsh, tile)


def _check_encode_crc(tables, chunks, block: int) -> None:
    n = _check_operands(tables, chunks)[2]
    if block % 128 or n % block:
        raise ValueError(f"gf_encode_crc needs block % 128 == 0 and a "
                         f"width multiple of the block ({n} % {block})")


def _encode_crc_launch(tables, chunks, block: int):
    m, k, n = _check_operands(tables, chunks)
    dev = chunks.device
    _crc_smem_bytes(m, k, block)
    parity = torch.empty((m, n), dtype=torch.uint8, device=dev)
    lout = torch.empty((k + m, n // block), dtype=torch.int64, device=dev)
    if n == 0:
        return parity, lout, False
    from . import _build
    lib = _build.load()
    ops = _k3_ops_tensor(block, dev)
    rc = lib.ctt_gf_encode_crc(tables.data_ptr(), chunks.data_ptr(),
                               parity.data_ptr(), lout.data_ptr(),
                               ops.data_ptr(), m, k, n, block,
                               _stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"gf_encode_crc launch failed: CUDA error {rc}")
    if not k2_lane_tables(m, k, block):
        _encode_crc_launch.narrow_launches += 1
    return parity, lout, True


# launches of K2's narrow branch (k2_lane_tables false), whichever entry
_encode_crc_launch.narrow_launches = 0


def fused_hier_call(tables: torch.Tensor, chunks: torch.Tensor,
                    wb: int = FUSED_WB):
    """K2, hier entry (contract of Pallas kernel #1): parity (m, N)
    uint8 and the L of every 4*wb-byte sub-block of all k+m rows,
    (k+m, N // (4*wb)) int64 in stream order."""
    _check_encode_crc(tables, chunks, 4 * wb)
    if chunks.device.type == "cpu":
        return fused_hier_call_plain(tables, chunks, wb)
    parity, ls, launched = _encode_crc_launch(tables, chunks, 4 * wb)
    if launched:
        fused_hier_call.launches += 1
    return parity, ls


fused_hier_call.launches = 0


def gf_encode_with_crc_w32(tables: torch.Tensor, chunks: torch.Tensor,
                           tile: int = FUSED_TILE):
    """K2, flat entry (contract of Pallas kernel #2): parity (m, N)
    uint8 and one L per `tile` bytes of all k+m rows, (k+m, N // tile)
    int64."""
    _check_encode_crc(tables, chunks, tile)
    if chunks.device.type == "cpu":
        return gf_encode_with_crc_w32_plain(tables, chunks, tile)
    parity, ls, launched = _encode_crc_launch(tables, chunks, tile)
    if launched:
        gf_encode_with_crc_w32.launches += 1
    return parity, ls


gf_encode_with_crc_w32.launches = 0


@functools.lru_cache(maxsize=16)
def _cmat_bytes(tile: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cl.crc_tile_matrix(tile)).to(
        device=device, dtype=torch.float32)


def gf_encode_with_crc_plain(tables: torch.Tensor, chunks: torch.Tensor,
                             tile: int = FUSED_TILE):
    """Plain version of the byte entry, by the byte-layout algorithm of
    Pallas kernel #6 (ceph_tpu's gf_encode_with_crc_xla :807): K1's
    plain parity, then the 8 bit-planes of every `tile`-byte block of
    all k+m rows against the (8*tile, 32) byte crc matrix."""
    parity = gf_bitmatmul_plain(tables, chunks)
    allsh = torch.cat([chunks, parity], dim=0)
    r, n = allsh.shape
    nt = n // tile
    blocks = allsh.reshape(r * nt, tile).to(torch.int32)
    cm = _cmat_bytes(tile, chunks.device)
    acc = torch.zeros((r * nt, 32), dtype=torch.float32, device=chunks.device)
    for i in range(8):
        acc += ((blocks >> i) & 1).to(torch.float32) @ \
            cm[i * tile:(i + 1) * tile]
    return parity, cl.bits_to_u32(acc.to(torch.int32) & 1).reshape(r, nt)


def gf_encode_with_crc(tables: torch.Tensor, chunks: torch.Tensor,
                       tile: int = FUSED_TILE):
    """K2, byte entry (contract of Pallas kernel #6): parity (m, N)
    uint8 and one L per `tile` bytes of all k+m rows, (k+m, N // tile)
    int64.  The write path's "bytes" branch (use_w32=False) launches it
    at the 2 KiB tile."""
    _check_encode_crc(tables, chunks, tile)
    if chunks.device.type == "cpu":
        return gf_encode_with_crc_plain(tables, chunks, tile)
    parity, ls, launched = _encode_crc_launch(tables, chunks, tile)
    if launched:
        gf_encode_with_crc.launches += 1
    return parity, ls


gf_encode_with_crc.launches = 0


# ----------------------------------------------------------------------------
# K3: fused parity + one crc32c L per (run, shard)
# ----------------------------------------------------------------------------

K3_THREADS = 384             # threads of a K3 block: 12 warps
# resident K3 blocks an SM that the launch bounds of
# csrc/gf_encode_crc_acc.cu guarantee (at most 56 registers a thread)
K3_BLOCKS_PER_SM = 3
MAX_THREADS_PER_SM = 2048
K3_DIGITS = 4                # base-256 digits of a distance the advance covers
K3_MAX_RUN_BLOCKS = 1 << 27  # blocks of one run
K3_MAX_CHAINS = 4            # interleaved crc chains a lane
# the fold's operators as k3_ops gives them: 32 lane operators and the
# chain operators, 32 columns each
K3_OP_COLS = 32 * 32 + (K3_MAX_CHAINS - 1) * 32
# their nibble tables in shared memory: 8 x 16 words an operator, a copy
# a lane for the lane operators
K3_NIB_WORDS = 8 * 16 * 32 + (K3_MAX_CHAINS - 1) * 8 * 16


def k3_pad(block: int) -> int:
    """Pad words after each lane's piece (block/128 words) of a row K3
    stages: 1, or 2 where the piece is odd, so that piece + pad is odd
    and the 32 lanes' word t of their pieces lie in 32 distinct banks."""
    return 2 if (block // 128) % 2 else 1


def k3_chains(block: int) -> int:
    """Independent crc chains a K3 lane runs over its piece of
    block/128 words: 4, 2 or 1, whichever divides the piece."""
    wpp = block // 128
    return 4 if wpp % 4 == 0 else 2 if wpp % 2 == 0 else 1


def _block_smem(m: int, k: int, block: int, lane_tables: bool = True) -> int:
    """Bytes of shared memory of one block of K3's per-block body
    (csrc/gf_encode_crc_acc.cu block_smem_bytes mirrors it): the nibble
    tables of the packed parity (32 words for each group of four parity
    rows and data row); with `lane_tables` the lane crc tables (32 KiB:
    entry e of lane l at word 32*e + l) and the fold's nibble tables
    (K3_NIB_WORDS words), else one crc table (1 KiB); k+m staged rows of
    block + 128*k3_pad(block) bytes; and 16 bytes of run and distance."""
    tables = 256 * 32 + K3_NIB_WORDS if lane_tables else 256
    words = (-(-m // 4) * k * 32 + tables
             + (k + m) * (block // 4 + 32 * k3_pad(block)))
    return 4 * words + 16


def _check_block(name: str, block: int) -> None:
    if block <= 0 or block % 128:
        raise ValueError(f"{name} needs a block that is a positive multiple "
                         f"of 128, got {block}")


@functools.lru_cache(maxsize=1024)
def k3_smem(m: int, k: int, block: int) -> int:
    """Bytes of shared memory of one K3 block: _block_smem with the lane
    tables.  Raises ValueError where the block is not a positive multiple
    of 128 or the layout exceeds SMEM_LIMIT."""
    _check_block("gf_encode_crc_acc", block)
    smem = _block_smem(m, k, block)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gf_encode_crc_acc: {smem} bytes of shared memory "
                         "exceed one block's")
    return smem


def k2_lane_tables(m: int, k: int, block: int) -> bool:
    """K2's branch, a pure function of the shape (ctt_gf_encode_crc
    chooses the same): K3's layout with the lane crc tables and the
    fold's nibble tables where it fits one block; else the narrow branch
    (one crc table the lanes share, the fold's operators applied from
    their columns), which k+m rows of 4-8 KiB need."""
    return _block_smem(m, k, block) <= SMEM_LIMIT


@functools.lru_cache(maxsize=1024)
def _crc_smem_bytes(m: int, k: int, block: int) -> int:
    """Bytes of shared memory of one K2 block on its branch
    (k2_lane_tables); raises ValueError only where no branch fits one
    block (or the block is not a positive multiple of 128).
    autotune._legal calls it."""
    _check_block("gf_encode_crc", block)
    smem = _block_smem(m, k, block, k2_lane_tables(m, k, block))
    if smem > SMEM_LIMIT:
        raise ValueError(f"gf_encode_crc: {smem} bytes of shared memory "
                         "exceed one block's")
    return smem


@functools.lru_cache(maxsize=1024)
def k3_launch(n: int, block: int, k: int, m: int, sm_count: int,
              acc: bool = True) -> int:
    """K3's grid for a width of n bytes, and with acc=False K2's
    (csrc/gf_encode_crc_acc.cu computes the same): one thread block for
    each block-byte tile of the width, at most one wave — sm_count times
    the blocks an SM keeps resident by the launch bounds, threads and
    shared memory (k3_smem, or K2's _crc_smem_bytes) — the blocks
    striding over the rest."""
    smem = (k3_smem if acc else _crc_smem_bytes)(m, k, block) \
        + BLOCK_SMEM_RESERVED
    per_sm = max(1, min(K3_BLOCKS_PER_SM, MAX_THREADS_PER_SM // K3_THREADS,
                        SM_SMEM // smem))
    return max(1, min(n // block, per_sm * sm_count))


@functools.lru_cache(maxsize=16)
def k3_ops(block: int) -> np.ndarray:
    """The crc operators K3 takes, as one uint32 array: the 32 x 32 fold
    operators (lane l's A_{(block/32) * (31 - l)}, column b at word
    32*b + l); the chain operators A_{sub * j}, j = 1 .. K3_MAX_CHAINS-1,
    sub = block/32/k3_chains(block) bytes, 32 columns each, which join a
    lane's chains (K3_OP_COLS words so far; every thread block turns
    them into nibble tables); then K3_DIGITS tables of 256 operators of
    32 columns, operator c of table i = A_{block * c * 256^i} — the
    advance of a block's L over c * 256^i blocks."""
    from ..common import crc32c as _crc
    piece = block // 32
    sub = piece // k3_chains(block)
    fold = np.stack([_crc.advance_op(piece * (31 - lane))
                     for lane in range(32)])
    chain = np.stack([_crc.advance_op(sub * j)
                      for j in range(1, K3_MAX_CHAINS)])
    ident = np.uint32(1) << np.arange(32, dtype=np.uint32)
    tabs = []
    for i in range(K3_DIGITS):
        step = _crc.advance_op(block << (8 * i))
        tab = [ident]
        for _ in range(255):
            tab.append(_crc.apply_op(step, tab[-1]))
        tabs.append(np.stack(tab))
    return np.concatenate([fold.T.ravel(), chain.ravel(),
                           np.stack(tabs).ravel()]).astype(np.uint32)


@functools.lru_cache(maxsize=16)
def _k3_ops_tensor(block: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(k3_ops(block).view(np.int32).copy()).to(device)


def _run_bounds(run_ends: torch.Tensor) -> list[tuple[int, int]]:
    ends = [int(e) for e in run_ends.tolist()]
    return list(zip([0] + ends[:-1], ends))


def fused_hier_acc_call_plain(tables: torch.Tensor, chunks: torch.Tensor,
                              run_ends: torch.Tensor, wb: int = FUSED_WB):
    """Plain version of K3, by another algorithm than the kernel's: K2's
    plain per-block L (fused_hier_call_plain), then one log-depth
    combine_crcs_pow2 fold over each run's blocks."""
    block = 4 * wb
    parity, ls = fused_hier_call_plain(tables, chunks, wb)
    r_tot = ls.shape[0]
    folds = [cl.combine_crcs_pow2(cl.u32_to_bits(ls[:, a:b]), block)
             for a, b in _run_bounds(run_ends)]
    lacc = cl.bits_to_u32(torch.stack(folds)) if folds else \
        torch.zeros((0, r_tot), dtype=torch.int64, device=chunks.device)
    return parity, lacc


def fused_hier_acc_call(tables: torch.Tensor, chunks: torch.Tensor,
                        run_ends: torch.Tensor, wb: int = FUSED_WB):
    """K3 (contract of Pallas kernel #4): parity (m, N) uint8 and one L
    per (run, shard) of all k+m rows, (nruns, k+m) int64.  The N
    columns are the runs laid end to end, each a whole number of
    4*wb-byte blocks; `run_ends` (nruns,) int64 on the chunks' device
    holds the cumulative block ends (_acc_launch_args builds and checks
    it: non-decreasing, the last == N / (4*wb))."""
    block = 4 * wb
    _check_encode_crc(tables, chunks, block)
    _check("run_ends", run_ends, chunks.device, torch.int64, 1)
    if run_ends.numel() == 0:
        raise ValueError("fused_hier_acc_call needs at least one run")
    if chunks.device.type == "cpu":
        bounds = _run_bounds(run_ends)
        if any(b < a for a, b in bounds) or \
                bounds[-1][1] != chunks.shape[1] // block:
            raise ValueError("run_ends must be non-decreasing and end at "
                             "the launch's block count")
        return fused_hier_acc_call_plain(tables, chunks, run_ends, wb)
    m, k, n = _check_operands(tables, chunks)
    dev = chunks.device
    k3_smem(m, k, block)
    nruns = run_ends.numel()
    parity = torch.empty((m, n), dtype=torch.uint8, device=dev)
    # the kernel XORs into the L slots: zero them first, in stream order
    lacc = torch.zeros((nruns, k + m), dtype=torch.int64, device=dev)
    if n == 0:
        return parity, lacc
    from . import _build
    lib = _build.load()
    ops = _k3_ops_tensor(block, dev)
    rc = lib.ctt_gf_encode_crc_acc(tables.data_ptr(), chunks.data_ptr(),
                                   parity.data_ptr(), lacc.data_ptr(),
                                   ops.data_ptr(), run_ends.data_ptr(),
                                   nruns, m, k, n, block, K3_DIGITS,
                                   _stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"gf_encode_crc_acc launch failed: CUDA error {rc}")
    fused_hier_acc_call.launches += 1
    return parity, lacc


fused_hier_acc_call.launches = 0


def _acc_launch_args(run_blocks, device: torch.device):
    """(staged, run_ends) for one K3 launch over a drain's runs: the
    cumulative block ends of runs of `run_blocks` blocks each, as int64
    on `device`, queued with a pinned non-blocking copy (a pageable one
    would synchronise the stream).  `staged` must stay referenced until
    the stream has passed the copy (the extents path keeps it in its
    handle)."""
    counts = np.asarray(list(run_blocks), dtype=np.int64)
    if counts.size == 0 or (counts < 0).any():
        raise ValueError(f"bad run block counts {counts.tolist()}")
    if counts.max() >= K3_MAX_RUN_BLOCKS:
        raise ValueError("a run of K3 is limited to 2^27 blocks")
    return stage(np.cumsum(counts), device)


def _hier_acc_core(tables: torch.Tensor, chunks: torch.Tensor, run_blocks,
                   wb: int):
    """One K3 launch over runs of `run_blocks` blocks laid end to end in
    `chunks`: (parity (m, N) uint8, L (nruns, k+m) int64 — one L per
    shard per run, covering every byte of the run — , the pinned
    staging the caller keeps until the stream has passed it)."""
    staged, run_ends = _acc_launch_args(run_blocks, chunks.device)
    parity, lacc = fused_hier_acc_call(tables, chunks, run_ends, wb)
    return parity, lacc, staged


def gf_encode_with_crc_w32_fold(tables: torch.Tensor, chunks: torch.Tensor,
                                wb: int = FUSED_WB, combine: str = "xla"):
    """Parity AND one crc32c L per shard of a single extent (ceph_tpu's
    gf_encode_with_crc_w32_fold :756): chunks (k, N) uint8, N a
    multiple of the 4*wb-byte block.  Returns (parity (m, N) uint8,
    L (k+m,) int64).  `combine` is the autotuner's axis:

      * "kernel": K3 folds the blocks' Ls inside the launch;
      * "xla": K2's per-block Ls, then one combine_crcs_pow2 chain of
        small launches (the name keeps the JAX point's vocabulary).
    """
    block = 4 * wb
    if combine == "kernel":
        _check_encode_crc(tables, chunks, block)
        # one run: its end is the block count, filled on the device
        run_ends = torch.full((1,), chunks.shape[1] // block,
                              dtype=torch.int64, device=chunks.device)
        parity, lacc = fused_hier_acc_call(tables, chunks, run_ends, wb)
        return parity, lacc[0]
    if combine != "xla":
        raise ValueError(f"unknown combine depth {combine!r}")
    parity, ls = fused_hier_call(tables, chunks, wb)
    return parity, cl.bits_to_u32(cl.combine_crcs_pow2(cl.u32_to_bits(ls),
                                                       block))


# ----------------------------------------------------------------------------
# K5: one crc32c L per row of byte rows laid end to end
# ----------------------------------------------------------------------------

K5_MAX_WARPS = 32            # warps of a K5 block at most: 1024 threads
K5_BLOCKS_PER_SM = 1         # resident K5 blocks an SM by the launch bounds
# the scrub block, which K5 compiles apart: a lane's 16-word piece every
# K5_SCRUB_STRIDE words (4 pad words), read and copied 16 bytes at a
# time, in K5_SCRUB_CHAINS chains
K5_SCRUB_BLOCK = 2048
K5_SCRUB_STRIDE = 20
K5_SCRUB_CHAINS = 2


def _k5_row_bytes(block: int) -> int:
    """Bytes of one staged row of a K5 warp: the scrub block's layout,
    else K3's (k3_pad)."""
    if block == K5_SCRUB_BLOCK:
        return 4 * 32 * K5_SCRUB_STRIDE
    return 4 * (block // 4 + 32 * k3_pad(block))


def k5_warps(block: int) -> int:
    """Warps of a K5 thread block (csrc/gf_encode_crc_acc.cu rows_warps
    mirrors it): as many as one block's shared memory holds two staged
    block-byte rows each (_k5_row_bytes) beside the lane crc tables and
    the fold's nibble tables, at most K5_MAX_WARPS.  Raises ValueError
    where the block is not a positive multiple of 128 or not one warp's
    rows fit."""
    _check_block("crc32c_rows", block)
    tables = 4 * (256 * 32 + K3_NIB_WORDS)
    warps = min(K5_MAX_WARPS,
                (SMEM_LIMIT - tables) // (2 * _k5_row_bytes(block)))
    if warps < 1:
        raise ValueError(f"crc32c_rows: two {block}-byte rows exceed one "
                         "block's shared memory")
    return warps


def k5_smem(block: int) -> int:
    """Bytes of shared memory of one K5 block (rows_smem_bytes mirrors
    it): the lane crc tables, the fold's nibble tables and two staged
    rows a warp (k5_warps)."""
    return (4 * (256 * 32 + K3_NIB_WORDS)
            + 2 * k5_warps(block) * _k5_row_bytes(block))


def k5_launch(nblocks: int, block: int, sm_count: int) -> int:
    """K5's grid (ctt_crc32c_rows computes the same): enough thread
    blocks for one block of the rows a warp, at most one resident wave
    (K5_BLOCKS_PER_SM, or what the shared memory allows, an SM)."""
    per_sm = max(1, min(K5_BLOCKS_PER_SM,
                        SM_SMEM // (k5_smem(block) + BLOCK_SMEM_RESERVED)))
    warps = k5_warps(block)
    return max(1, min(-(-nblocks // warps), per_sm * sm_count))


def k5_ranges(nblocks: int, nwarps: int) -> list[tuple[int, int]]:
    """The contiguous block range [b0, b1) of each of K5's `nwarps`
    warps (the grid's, in order): nblocks split evenly, the first
    nblocks % nwarps ranges one block longer."""
    per, rem = divmod(nblocks, nwarps)
    return [(w * per + min(w, rem), (w + 1) * per + min(w + 1, rem))
            for w in range(nwarps)]


def _check_rows(data, row_ends, block: int) -> tuple[int, int]:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got {type(data)}")
    _check("data", data, data.device, torch.uint8, 1)
    _check("row_ends", row_ends, data.device, torch.int64, 1)
    if row_ends.numel() == 0:
        raise ValueError("crc32c_rows needs at least one row")
    if data.numel() % block:
        raise ValueError(f"crc32c_rows: {data.numel()} bytes are not whole "
                         f"{block}-byte blocks")
    return row_ends.numel(), data.numel() // block


def crc32c_rows_l_plain(data: torch.Tensor, row_ends: torch.Tensor,
                        block: int = cl.SCRUB_BLOCK) -> torch.Tensor:
    """Plain version of K5 (and of the JAX package's `_rows_l`): every
    block's L by subblock_crc_bits_w32, then one combine_crcs_pow2 over
    each row's blocks, rows of one block count folded together."""
    nrows, nblocks = _check_rows(data, row_ends, block)
    dev = data.device
    out = torch.zeros(nrows, dtype=torch.int64, device=dev)
    if nblocks == 0:
        return out
    wb = block // 4
    lbits = cl.subblock_crc_bits_w32(data.view(torch.int32).reshape(1, -1),
                                     _cmat_w32(wb, dev), wb)
    bounds = _run_bounds(row_ends)
    if any(b < a for a, b in bounds) or bounds[-1][1] != nblocks:
        raise ValueError("row_ends must be non-decreasing and end at the "
                         "block count")
    by_count: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(bounds):
        if b > a:
            by_count.setdefault(b - a, []).append(i)
    for cnt, idxs in by_count.items():
        starts = torch.tensor([bounds[i][0] for i in idxs], device=dev)
        sel = lbits[starts[:, None] + torch.arange(cnt, device=dev)]
        out[torch.tensor(idxs, device=dev)] = cl.bits_to_u32(
            cl.combine_crcs_pow2(sel, block))
    return out


def crc32c_rows_l(data: torch.Tensor, row_ends: torch.Tensor,
                  block: int = cl.SCRUB_BLOCK) -> torch.Tensor:
    """K5 (the device program of the JAX package's crc32c_rows_device):
    one L = crc(body, 0) per row, (nrows,) int64.  `data` (N,) uint8
    holds the rows' bodies laid end to end, each a whole number of
    `block`-byte blocks; `row_ends` (nrows,) int64 on its device the
    cumulative block ends (non-decreasing, the last == N / block).  The
    plain version checks the ends; on the card they are built and
    checked on the host by _rows_launch_args, as K3's are."""
    nrows, nblocks = _check_rows(data, row_ends, block)
    if data.device.type == "cpu":
        return crc32c_rows_l_plain(data, row_ends, block)
    dev = data.device
    k5_smem(block)
    # the kernel XORs into the L slots: zero them first, in stream order
    lout = torch.zeros(nrows, dtype=torch.int64, device=dev)
    if nblocks == 0:
        return lout
    from . import _build
    lib = _build.load()
    ops = _k3_ops_tensor(block, dev)
    rc = lib.ctt_crc32c_rows(data.data_ptr(), lout.data_ptr(),
                             ops.data_ptr(), row_ends.data_ptr(), nrows,
                             nblocks, block, K3_DIGITS, _stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"crc32c_rows launch failed: CUDA error {rc}")
    crc32c_rows_l.launches += 1
    return lout


crc32c_rows_l.launches = 0


def _rows_launch_args(row_blocks, nblocks: int, device: torch.device):
    """(staged, row_ends) for one K5 launch: the cumulative block ends
    of rows of `row_blocks` blocks each, which must add up to the
    launch's `nblocks`, as int64 on `device` through a pinned
    non-blocking copy.  `staged` must stay referenced until the stream
    has passed the copy."""
    counts = np.asarray(list(row_blocks), dtype=np.int64)
    if counts.size == 0 or (counts < 0).any():
        raise ValueError(f"bad row block counts {counts.tolist()}")
    if int(counts.sum()) != nblocks:
        raise ValueError(f"row_ends must end at the block count: rows of "
                         f"{int(counts.sum())} blocks, {nblocks} staged")
    return stage(np.cumsum(counts), device)


KERNEL_WRAPPERS = (gf_bitmatmul, fused_hier_call, gf_encode_with_crc_w32,
                   fused_hier_acc_call, gf_encode_with_crc,
                   gf_bitmatmul_stream, crc32c_rows_l)


def launch_counts() -> dict[str, int]:
    return {f.__name__: f.launches for f in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for f in KERNEL_WRAPPERS:
        f.launches = 0


# ----------------------------------------------------------------------------
# host <-> device staging
# ----------------------------------------------------------------------------

def stage(host, device: torch.device):
    """(pinned host tensor, device tensor) for a numpy array: the copy
    to the card is queued on the current stream without waiting.  The
    pinned tensor must stay referenced until the stream has passed the
    copy (the caller keeps it in its handle).  `host` may also be a
    list of 1-D arrays of one dtype: they are gathered end to end
    straight into the one pinned buffer."""
    if isinstance(host, (list, tuple)):
        parts = [np.ascontiguousarray(p).ravel() for p in host]
        if device.type == "cpu":
            t = torch.from_numpy(np.concatenate(parts))
            return t, t
        dtype = torch.from_numpy(np.empty(0, parts[0].dtype)).dtype
        pinned = torch.empty(sum(p.size for p in parts), dtype=dtype,
                             pin_memory=True)
        flat, off = pinned.numpy(), 0
        for p in parts:
            flat[off:off + p.size] = p
            off += p.size
        return pinned, pinned.to(device, non_blocking=True)
    host = np.ascontiguousarray(host)
    if device.type == "cpu":
        t = torch.from_numpy(host)
        return t, t
    pinned = torch.empty(host.shape, dtype=torch.from_numpy(host).dtype,
                         pin_memory=True)
    pinned.numpy()[...] = host
    return pinned, pinned.to(device, non_blocking=True)


def to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Queue a device -> pinned host copy; read it after the handle's
    event has completed."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def record_event(device: torch.device):
    """The event finalize waits on (None on the CPU, where every op has
    already run)."""
    if device.type == "cpu":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def wait(event) -> None:
    if event is not None:
        event.synchronize()


# ----------------------------------------------------------------------------
# the multi-extent launch contract (ceph_tpu bitsliced.py:858-1160)
# ----------------------------------------------------------------------------

def gf_encode_extents_with_crc(tables, runs, tile: int | None = None,
                               wb: int | None = None, combine: str = "xla",
                               use_w32: bool = True):
    """Parity + one combined crc32c L per shard for every run of a
    drain: per run (parity (m, Wi) uint8, l (k+m,) uint32 over the run's
    body, tail_bytes (k+m, tail_len) uint8, body_bytes).  Fold with
    crc32c_linear.fold_run_crc seeded per shard.  On the accumulator
    path (combine="kernel") each L covers the run's every byte: the
    tail is empty and body_bytes == Wi."""
    return gf_encode_extents_with_crc_finalize(
        gf_encode_extents_with_crc_submit(tables, runs, tile=tile, wb=wb,
                                          combine=combine, use_w32=use_w32))


def gf_encode_extents_with_crc_submit(tables: torch.Tensor, runs,
                                      tile: int | None = None,
                                      wb: int | None = None,
                                      combine: str = "xla",
                                      use_w32: bool = True) -> dict:
    """Dispatch half: stage the drain's runs, launch parity + crc (and,
    on the "xla" combine, the per-run device L folds), queue the
    results' copies to the host, and return a handle — nothing here
    waits for the card.

    `tile` (the hier threshold, default FUSED_TILE_HIER = 128 KiB), `wb`
    (the hier crc block in words, default FUSED_WB) and `combine` are
    the autotuned operating point (ops/autotune via the plugin).  Runs
    at least `tile` wide take the hier kernels (L per 4*wb-byte block),
    narrower drains the flat entry (L per 2 KiB tile).  A drain mixing
    both splits into one launch of each, demuxed back to the caller's
    run order at finalize.  Runs concatenate along the byte axis, each
    zero-padded to a block multiple (zero bytes encode to zero parity):

      * combine="kernel", hier: K3, path "hier_acc".  Each run is
        padded at the FRONT — a zero prefix leaves L unchanged — so
        the launch's one L per (run, shard) covers every byte of the
        run and the host folds no tail.  The pads are in the handle.
      * otherwise: K2, path "hier_lsub" or "w32_flat", padded at the
        back; each run's full blocks fold on the device with one
        combine_crcs_pow2 chain and the sub-block tail goes to the
        host (the padded block's L is never read).

    `use_w32=False` is ceph_tpu's byte branch (its plugin's `_use_w32`):
    no split and no hier entry; every run is back-padded to the 2 KiB
    tile and the drain is one launch of K2's byte entry
    (gf_encode_with_crc), folded as above, path "bytes"."""
    if combine not in ("xla", "kernel"):
        raise ValueError(f"unknown combine depth {combine!r}")
    device = tables.device
    m, k = tables.shape[0], tables.shape[1]
    runs = [np.ascontiguousarray(r, dtype=np.uint8) for r in runs]
    if not runs or any(r.ndim != 2 or r.shape[0] != k for r in runs):
        raise ValueError("every run of one launch must be (k, W) with "
                         f"k={k}")
    tile_hier = tile or FUSED_TILE_HIER
    wb = wb or FUSED_WB
    big_idx = [i for i, r in enumerate(runs)
               if use_w32 and r.shape[1] >= tile_hier]
    if 0 < len(big_idx) < len(runs):
        small_idx = [i for i, r in enumerate(runs)
                     if r.shape[1] < tile_hier]
        parts = [(idxs, gf_encode_extents_with_crc_submit(
            tables, [runs[i] for i in idxs], tile=tile, wb=wb,
            combine=combine))
            for idxs in (big_idx, small_idx)]
        return {"split": parts, "n_runs": len(runs),
                "path": "+".join(h["path"] for _, h in parts)}
    hier = len(big_idx) == len(runs)
    acc = hier and combine == "kernel"
    block = 4 * wb if hier else FUSED_TILE
    meta = [r.shape[1] for r in runs]
    pads = [-w % block for w in meta]
    padded = [np.pad(r, ((0, 0), (p, 0) if acc else (0, p))) if p else r
              for r, p in zip(runs, pads)]
    big = padded[0] if len(padded) == 1 else np.concatenate(padded, axis=1)
    if not big.shape[1]:
        # every run is empty (an object create): nothing to launch, and
        # each run's parity is empty with no L (ceph_tpu launches one
        # zero tile here, its pow2 bucket of zero tiles)
        return {"meta": meta, "padded": padded, "block_bytes": block,
                "pads": [0] * len(runs), "acc": False, "r_tot": k + m,
                "m": m, "big_width": 0,
                "path": "w32_flat" if use_w32 else "bytes",
                "has_l": [False] * len(runs), "staged": None,
                "parity_host": torch.zeros((m, 0), dtype=torch.uint8),
                "l_host": None, "event": None}
    staged, dev = stage(big, device)
    if acc:
        parity_dev, l_dev, staged_ends = _hier_acc_core(
            tables, dev, [pr.shape[1] // block for pr in padded], wb)
        staged = (staged, staged_ends)
        has_l = [True] * len(runs)
        path = "hier_acc"
    else:
        if hier:
            parity_dev, ls = fused_hier_call(tables, dev, wb)
            path = "hier_lsub"
        elif use_w32:
            parity_dev, ls = gf_encode_with_crc_w32(tables, dev, block)
            path = "w32_flat"
        else:
            parity_dev, ls = gf_encode_with_crc(tables, dev, block)
            path = "bytes"
        # per-run device combines of each run's full blocks: one L per
        # shard
        folds = []
        has_l = []
        coff = 0
        for w, pr in zip(meta, padded):
            nb = w // block
            has_l.append(nb > 0)
            if nb:
                boff = coff // block
                folds.append(cl.combine_crcs_pow2(
                    cl.u32_to_bits(ls[:, boff:boff + nb]), block))
            coff += pr.shape[1]
        l_dev = cl.bits_to_u32(torch.stack(folds)) if folds else None
    return {"meta": meta, "padded": padded, "block_bytes": block,
            "pads": pads if acc else [0] * len(runs), "acc": acc,
            "r_tot": k + m, "m": m, "big_width": big.shape[1],
            "path": path, "has_l": has_l, "staged": staged,
            "parity_host": to_host_async(parity_dev),
            "l_host": to_host_async(l_dev) if l_dev is not None else None,
            "event": record_event(device)}


def gf_encode_extents_with_crc_finalize(handle: dict) -> list[tuple]:
    """Completion half: the only place that waits for the card.  Returns
    the per-run (parity, l, tail_bytes, body_bytes) tuples; on the
    "hier_acc" path body == the run's width and the tail is empty."""
    if "split" in handle:
        out = [None] * handle["n_runs"]
        for idxs, sub in handle["split"]:
            for i, res in zip(idxs, gf_encode_extents_with_crc_finalize(sub)):
                out[i] = res
        return out
    wait(handle["event"])
    r_tot = handle["r_tot"]
    block = handle["block_bytes"]
    parity_big = handle["parity_host"].numpy()
    ls = handle["l_host"].numpy().astype(np.uint32) \
        if handle["l_host"] is not None else None
    out = []
    coff = 0
    li = 0
    for w, pr, pad, has in zip(handle["meta"], handle["padded"],
                               handle["pads"], handle["has_l"]):
        par = parity_big[:, coff + pad:coff + pad + w]
        body = w if handle["acc"] else (w // block) * block
        if has:
            l = ls[li]
            li += 1
        else:
            l = np.zeros(r_tot, dtype=np.uint32)
        tail_bytes = np.concatenate([pr[:, pad + body:pad + w],
                                     par[:, body:w]], axis=0) \
            if w > body else np.zeros((r_tot, 0), dtype=np.uint8)
        out.append((par, l, tail_bytes, body))
        coff += pr.shape[1]
    return out

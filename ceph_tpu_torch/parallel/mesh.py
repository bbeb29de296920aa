"""Multi-card sharding of the erasure-code data plane, and CLAY repair.

The port of ceph_tpu/parallel/mesh.py.  Two parts.

`make_mesh` and `DistributedStripeCodec`: the sharded GF(2^8)
contraction over a ('shard', 'data') mesh of torch devices, which one
process drives, as JAX's single controller does.

  axis 'shard' — over the source rows.  Shard s owns rows
      [s*k_local, (s+1)*k_local) and holds the product tables of its
      column slice of the coefficient matrix on its devices.  Each
      device applies its slice to its block, and the partial results
      XOR-fold to the total (GF(2^8) addition is XOR, so partials of a
      split contraction XOR to the whole).
  axis 'data' — over the byte axis, no communication: columns are
      independent, like separate PGs.

On each device the local apply is K1 (ops/bitsliced.gf_bitmatmul), the
counterpart of the Pallas kernel #3 the reference runs there off the
CPU (`gf_bitmatmul_pallas_w32`, ceph_tpu/parallel/mesh.py:142-147).
Where a shard's product tables exceed K1's shared memory
(bitsliced.k1_tables_fit: the CLAY repair matrices, 64 x 176 on a 1x1
mesh) it is K4 (gf_bitmatmul_stream), as ClayRepairPlan.apply_device
runs it; the reference runs #3 there, whose whole bit-matrix fits the
TPU's VMEM.  The reference's `use_w32` and `interpret` switches (TPU
layout, Pallas interpret mode) are not carried; its byte-axis quantum
of LANE * 4 becomes 16 bytes a data column, so K1 may take 16 bytes of
a row a thread.

The gather over 'shard' is picked from the mesh's layout when the mesh
is built (`Mesh.gather`): "nccl" where each data column's shard members
are distinct CUDA devices (`torch.cuda.nccl.all_gather` of the
partials, then the fold on the column's first member: NCCL has no XOR
reduction); "local" where they share one device (a mesh that repeats a
device, or the CPU), whose partials are already there; "none" for a
one-member shard axis.  The fold is `torch.bitwise_xor`, as the
reference's is a jnp fold, not a kernel.  An explicit `devices` list
may repeat a device: that is how the CPU tests build a 4x2 mesh (the
reference's tests use 8 virtual CPU devices) and how a sharded mesh
runs on one card.

Submit stages each device's block with a pinned copy
(bitsliced.stage) and launches with no host sync; finalize waits on one
event per data column and copies back.  The host (r, W) uint8 result is
the reference's.

`ClayRepairPlan`: the CLAY repair lowering on one device (below).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from ..common.util import concat_columns, split_columns
from ..ec import gf
from ..ops import bitsliced
from ..ops.profiler import device_profiler

# bytes of a data column's width the byte axis pads to
COLUMN_QUANTUM = 16


def _on(device: torch.device):
    """Make `device` current for launches on it (the current card is
    per thread)."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


class Mesh:
    """An (n_shard, n_data) array of torch devices with axes ('shard',
    'data'), and the gather its layout takes."""

    def __init__(self, devices: list[torch.device], n_shard: int,
                 n_data: int):
        self.devices = [[devices[s * n_data + d] for d in range(n_data)]
                        for s in range(n_shard)]
        self.shape = {"shard": n_shard, "data": n_data}
        types = {dv.type for dv in devices}
        if len(types) != 1:
            raise ValueError(f"a mesh is all CUDA or all CPU, got {types}")
        members = [{dv for dv in self.column(d)} for d in range(n_data)]
        if n_shard == 1:
            self.gather = "none"
        elif all(len(ms) == 1 for ms in members):
            self.gather = "local"
        elif types == {"cuda"} and all(len(ms) == n_shard
                                       for ms in members):
            self.gather = "nccl"
        else:
            raise ValueError("each data column's shard members must be "
                             "one device or distinct CUDA devices")

    def column(self, d: int) -> list[torch.device]:
        """Data column d's devices, shard by shard."""
        return [row[d] for row in self.devices]

    def distinct_devices(self) -> list[torch.device]:
        out: list[torch.device] = []
        for row in self.devices:
            out.extend(dv for dv in row if dv not in out)
        return out


def make_mesh(n_shard: int, n_data: int, devices=None) -> Mesh:
    """A ('shard', 'data') mesh of the first n_shard*n_data devices:
    by default the CUDA devices, else the given list ("cuda:0", "cpu",
    torch.device...), which may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    need = n_shard * n_data
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(devs[:need], n_shard, n_data)


class DistributedStripeCodec:
    """Sharded batched RS encode/decode over a device mesh.

    Two entry families, as in the reference:

      encode_flat / decode_flat — (k, W) chunk rows, the OSD pipeline's
          drain layout (ECBackend concatenates every extent of a drain
          along the byte axis);
      encode — (B, k, C) stripe batches (benchmarks, tests).

    Per-shard product tables are cached per (survivors, targets) decode
    and per CLAY plan signature, on the devices of their shard."""

    def __init__(self, k: int, m: int, mesh: Mesh,
                 technique: str = "cauchy"):
        self.k, self.m, self.mesh = k, m, mesh
        self.n_shard = mesh.shape["shard"]
        self.n_data = mesh.shape["data"]
        if k % self.n_shard:
            raise ValueError(
                f"k={k} not divisible by shard axis {self.n_shard}")
        self.k_local = k // self.n_shard
        self.matrix = (gf.cauchy_rs_matrix(k, m) if technique == "cauchy"
                       else gf.vandermonde_rs_matrix(k, m))
        self._lock = threading.Lock()
        self.enc_tables = self._column_tables(self.matrix[k:])
        self._decode_plans: dict[tuple, list] = {}
        self._clay_plans: dict[tuple, list] = {}

    # -- product-table plumbing ---------------------------------------------

    def _column_tables(self, coeff: np.ndarray,
                       cols_per_shard: int | None = None) -> list[dict]:
        """(r, j) GF(2^8) matrix -> per shard s, {device: the (r, cps,
        256) product tables of columns [s*cps, (s+1)*cps)} on each device
        of the shard's row.  Defaults to the k_local encode/decode
        split; the CLAY repair passes its own (padded) split."""
        cps = self.k_local if cols_per_shard is None else cols_per_shard
        out = []
        for s, row in enumerate(self.mesh.devices):
            prods = gf.product_tables(np.ascontiguousarray(
                coeff[:, s * cps:(s + 1) * cps]))
            out.append({dv: bitsliced.tables_tensor(prods, dv)
                        for dv in dict.fromkeys(row)})
        return out

    @staticmethod
    def _local_apply(tables: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One device's share of the contraction: K1, or K4 where the
        shard's tables exceed K1's shared memory."""
        r, kl, _ = tables.shape
        if bitsliced.k1_tables_fit(r, kl):
            return bitsliced.gf_bitmatmul(tables, x)
        return bitsliced.gf_bitmatmul_stream(tables, x)

    def _fold(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """XOR-fold one data column's partials over 'shard', on the
        column's first member."""
        gather = self.mesh.gather
        if gather == "none":
            return parts[0]
        if gather == "nccl":
            outs = [torch.empty((len(parts),) + tuple(p.shape),
                                dtype=p.dtype, device=p.device)
                    for p in parts]
            torch.cuda.nccl.all_gather(parts, outs)
            parts = list(outs[0].unbind(0))
        return functools.reduce(torch.bitwise_xor, parts)

    def _quantum(self) -> int:
        """Byte-axis pad quantum: every data column a multiple of
        COLUMN_QUANTUM bytes."""
        return self.n_data * COLUMN_QUANTUM

    def _apply_flat_submit(self, tables: list[dict], rows: np.ndarray,
                           r: int) -> dict:
        """Dispatch half of the sharded contraction: stage each device's
        block, launch its local apply, fold each data column and queue
        its copy back; returns a handle without waiting for the card."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        j, w = rows.shape
        if j % self.n_shard:
            raise ValueError(f"{j} rows do not divide over the shard axis "
                             f"{self.n_shard}")
        pad = -w % self._quantum()
        jl, wl = j // self.n_shard, (w + pad) // self.n_data
        staged, cols = [], []
        for d in range(self.n_data):
            parts = []
            for s, dv in enumerate(self.mesh.column(d)):
                block = rows[s * jl:(s + 1) * jl, d * wl:(d + 1) * wl]
                if block.shape[1] < wl:
                    # the ragged end of the byte axis: zero columns
                    # encode to zero and are cropped at finalize
                    block = np.pad(block, ((0, 0), (0, wl - block.shape[1])))
                with _on(dv):
                    pinned, x = bitsliced.stage(block, dv)
                    staged.append(pinned)
                    parts.append(self._local_apply(tables[s][dv], x))
            lead = self.mesh.column(d)[0]
            with _on(lead):
                folded = self._fold(parts)
                cols.append((bitsliced.to_host_async(folded),
                             bitsliced.record_event(lead)))
        return {"cols": cols, "staged": staged, "r": r, "w": w, "pad": pad}

    def _apply_flat_finalize(self, handle: dict) -> np.ndarray:
        cols = handle["cols"]
        for _host, event in cols:
            bitsliced.wait(event)
        if len(cols) == 1:
            out = cols[0][0].numpy()
        else:
            out = np.concatenate([host.numpy() for host, _ in cols],
                                 axis=1)
        return out[:, :handle["w"]] if handle["pad"] else out

    def _apply_flat(self, tables, rows: np.ndarray, r: int) -> np.ndarray:
        """rows (j, W) uint8 (j = k data rows or k survivor rows) ->
        (r, W) uint8 via the sharded contraction."""
        return self._apply_flat_finalize(
            self._apply_flat_submit(tables, rows, r))

    # -- device-resident entry (no host round-trip) -------------------------

    def apply_words(self, tables: list[dict], words: torch.Tensor,
                    r: int) -> torch.Tensor:
        """Device-resident contraction for callers that keep the data
        plane on the card (benchmarks, chained pipelines): `words` (k,
        W) uint8 on any device, W a multiple of the byte-axis quantum
        (the name is the reference's, whose device layout was int32
        words; the port's is bytes).  Returns the (r, W) uint8 result
        on the device of `words`, with no host traffic."""
        if words.dim() != 2 or words.shape[1] % self._quantum():
            raise ValueError(f"words must be (j, W) with W a multiple of "
                             f"{self._quantum()}, got {tuple(words.shape)}")
        jl = words.shape[0] // self.n_shard
        wl = words.shape[1] // self.n_data
        out = []
        for d in range(self.n_data):
            parts = []
            for s, dv in enumerate(self.mesh.column(d)):
                with _on(dv):
                    x = words[s * jl:(s + 1) * jl, d * wl:(d + 1) * wl] \
                        .to(dv).contiguous()
                    part = self._local_apply(tables[s][dv], x)
                    if part.shape[0] != r:
                        raise ValueError(f"tables give {part.shape[0]} "
                                         f"rows, expected {r}")
                    parts.append(part)
            with _on(self.mesh.column(d)[0]):
                out.append(self._fold(parts).to(words.device))
        return out[0] if len(out) == 1 else torch.cat(out, dim=1)

    def encode_words(self, words: torch.Tensor) -> torch.Tensor:
        """Device-resident sharded encode: (k, W) uint8 -> (m, W)."""
        return self.apply_words(self.enc_tables, words, self.m)

    # -- encode (host byte API: the OSD pipeline entry) ---------------------

    def encode_flat(self, chunks: np.ndarray) -> np.ndarray:
        """(k, W) uint8 data rows -> (m, W) parity.  ECBackend hands a
        drain's plain runs here when a mesh is configured."""
        if chunks.shape[0] != self.k:
            raise ValueError(f"need k={self.k} rows, got {chunks.shape[0]}")
        return self._apply_flat(self.enc_tables, chunks, self.m)

    def encode_flat_submit(self, chunks: np.ndarray) -> dict:
        """Dispatch half of encode_flat (no host sync); materialize with
        encode_flat_finalize.  The ECBackend drain entry."""
        if chunks.shape[0] != self.k:
            raise ValueError(f"need k={self.k} rows, got {chunks.shape[0]}")
        return self._apply_flat_submit(self.enc_tables, chunks, self.m)

    def encode_flat_finalize(self, handle: dict) -> np.ndarray:
        return self._apply_flat_finalize(handle)

    def encode(self, stripes) -> np.ndarray:
        """stripes (B, k, C) uint8 -> parity (B, m, C): batch and byte
        axes ride 'data' together via the flat layout."""
        stripes = np.ascontiguousarray(stripes, dtype=np.uint8)
        b, k, c = stripes.shape
        if k != self.k:
            raise ValueError(f"stripes have k={k}, the codec k={self.k}")
        flat = stripes.transpose(1, 0, 2).reshape(k, b * c)
        par = self.encode_flat(flat)
        return par.reshape(self.m, b, c).transpose(1, 0, 2)

    # -- decode / repair ----------------------------------------------------

    def _decode_tables(self, survivors: tuple[int, ...],
                       targets: tuple[int, ...]) -> list[dict]:
        """Column-sharded tables of the (targets x survivors) recovery
        matrix, cached per (survivors, targets)."""
        key = (survivors, targets)
        with self._lock:
            hit = self._decode_plans.get(key)
        if hit is not None:
            return hit
        coeff = gf.recovery_matrix(self.matrix, self.k, survivors, targets)
        tables = self._column_tables(coeff)
        with self._lock:
            self._decode_plans[key] = tables
        return tables

    def decode_flat(self, avail: np.ndarray, survivors, targets
                    ) -> np.ndarray:
        """Distributed reconstruct: `avail` (k, W) holds the survivor
        shards' bytes in `survivors` order; returns the rebuilt `targets`
        shards (len(targets), W)."""
        survivors = tuple(survivors)
        targets = tuple(targets)
        if len(survivors) != self.k:
            raise ValueError(f"need exactly k={self.k} survivors")
        tables = self._decode_tables(survivors, targets)
        return self._apply_flat(tables, avail, len(targets))

    def decode_flat_batch(self, avail_list, survivors, targets
                          ) -> list[np.ndarray]:
        """Batched distributed repair: many objects' survivor rows (same
        survivor/target pattern — the OSD-loss storm case) ride one
        sharded contraction, byte axes concatenated.  avail_list: [(k,
        W_i) uint8] in `survivors` order; returns the rebuilt targets
        per object."""
        if not avail_list:
            return []
        survivors = tuple(survivors)
        targets = tuple(targets)
        if len(survivors) != self.k:
            raise ValueError(f"need exactly k={self.k} survivors")
        big, widths = concat_columns(avail_list)
        prof = device_profiler()
        rec = prof.begin("mesh_decode",
                         codec=f"mesh:k{self.k}m{self.m}",
                         runs=len(avail_list), nbytes=int(big.size))
        tables = self._decode_tables(survivors, targets)
        handle = self._apply_flat_submit(tables, big, len(targets))
        tgt = "".join(str(t) for t in targets)
        prof.submitted(rec, f"mesh:d{tgt}:w{big.shape[1]}", path="mesh")
        t0 = time.perf_counter()
        out = self._apply_flat_finalize(handle)
        prof.materialized(rec, time.perf_counter() - t0)
        return split_columns(out, widths)

    def clay_repair_batch(self, plan: "ClayRepairPlan",
                          rows_list) -> list[np.ndarray]:
        """Batched distributed CLAY repair: many objects lost the same
        chunk to the same helper set, each object's stacked helper
        repair-plane rows (d*P, S_i) riding one sharded contraction.
        The repair matrix's input rows pad with zero rows (and zero
        matrix columns) to divide over the shard axis; zero rows
        XOR-fold to nothing."""
        if not rows_list:
            return []
        j = plan.in_rows
        pad = -j % self.n_shard
        with self._lock:
            tables = self._clay_plans.get(plan.signature)
        if tables is None:
            coeff = plan.matrix
            if pad:
                coeff = np.concatenate(
                    [coeff, np.zeros((plan.out_rows, pad),
                                     dtype=np.uint8)], axis=1)
            tables = self._column_tables(
                coeff, cols_per_shard=(j + pad) // self.n_shard)
            with self._lock:
                self._clay_plans[plan.signature] = tables
        big, widths = concat_columns(rows_list)
        if pad:
            big = np.concatenate(
                [big, np.zeros((pad, big.shape[1]), dtype=np.uint8)],
                axis=0)
        prof = device_profiler()
        rec = prof.begin("mesh_clay_repair",
                         codec=f"mesh:k{self.k}m{self.m}",
                         runs=len(rows_list), nbytes=int(big.size))
        handle = self._apply_flat_submit(tables, big, plan.out_rows)
        sig = abs(hash(plan.signature)) & 0xFFFFFF
        prof.submitted(rec, f"mesh:r{sig:x}:w{big.shape[1]}", path="mesh")
        t0 = time.perf_counter()
        out = self._apply_flat_finalize(handle)
        prof.materialized(rec, time.perf_counter() - t0)
        return split_columns(out, widths)

    def decode(self, stripes_avail, survivors, targets) -> np.ndarray:
        """(B, k, C) survivor stripes -> (B, len(targets), C)."""
        a = np.ascontiguousarray(stripes_avail, dtype=np.uint8)
        b, k, c = a.shape
        flat = a.transpose(1, 0, 2).reshape(k, b * c)
        out = self.decode_flat(flat, survivors, targets)
        return out.reshape(len(tuple(targets)), b, c).transpose(1, 0, 2)

    # -- oracle -------------------------------------------------------------

    def encode_reference(self, stripes) -> np.ndarray:
        """Single-host oracle for tests."""
        coding = self.matrix[self.k:]
        return np.stack([gf.gf_matvec(coding, s)
                         for s in np.asarray(stripes, dtype=np.uint8)])


# ----------------------------------------------------------------------------
# CLAY repair on the card
# ----------------------------------------------------------------------------
#
# ec/plugins/ec_clay.py's repair() is GF(2^8)-linear in the helper
# symbols, so the whole coupled-layer contraction — pairwise decouple
# transforms, per-plane parity-check solves in score order, final
# re-coupling — collapses to ONE (sub_chunks x d*P) matrix per (lost
# chunk, helper set), extracted on the host by an identity probe
# (ErasureCodeClay.repair_matrix) and applied here as one GF(2^8) matrix
# apply with many objects' byte axes concatenated.  On the card that
# apply is K4 (`ops/bitsliced.gf_bitmatmul_stream`): the matrices are
# 64 x 176 at k=8 m=4 d=11 and 81 x 270 at k=8 m=3 d=10, whose product
# tables K1 refuses, and K4 contracts their source rows in passes that
# fit one block's shared memory.
#
# Deviation from the reference: the JAX `apply()` catches every
# exception of the device apply and falls back to the host matvec.  Here
# `apply()` runs on the plan's device — the card unless the plan was
# built with `device="cpu"` — and swallows nothing: a failed build or
# launch raises.


class ClayRepairPlan:
    """One (lost, helpers) repair lowering: the GF(2^8) matrix plus its
    product tables on the plan's device, built once.  Shareable across
    PGs/backends of the same geometry (the signature is the coalescing
    key a launch queue batches on)."""

    def __init__(self, matrix: np.ndarray, signature: tuple,
                 lost_chunk: int, helper_ids: tuple[int, ...],
                 device: str | torch.device = "cuda"):
        self.matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        self.out_rows, self.in_rows = self.matrix.shape
        self.signature = signature
        self.lost_chunk = lost_chunk
        self.helper_ids = tuple(helper_ids)
        self.device = resolve_device(device)
        self._tables: torch.Tensor | None = None

    @classmethod
    def build(cls, plugin, lost_chunk: int, helper_ids=None,
              device: str | torch.device = "cuda") -> "ClayRepairPlan":
        """Lower one single-failure repair of a sub-chunked plugin
        (ErasureCodeClay.repair_matrix) into a plan on `device`."""
        helpers = plugin.repair_helper_order(lost_chunk, helper_ids)
        return cls(plugin.repair_matrix(lost_chunk, helpers),
                   plugin.repair_signature(lost_chunk, helpers),
                   lost_chunk, helpers, device)

    # -- host oracle ---------------------------------------------------------

    def apply_host(self, rows: np.ndarray) -> np.ndarray:
        """(in_rows, W) helper rows -> (out_rows, W) rebuilt sub-chunk
        rows via the host GF matvec (the oracle)."""
        return gf.gf_matvec(self.matrix, rows)

    # -- single-device path --------------------------------------------------

    def tables_tensor(self) -> torch.Tensor:
        """The matrix's (out_rows, in_rows, 256) product tables on the
        plan's device, built on the first call."""
        if self._tables is None:
            self._tables = bitsliced.tables_tensor(
                gf.product_tables(self.matrix), self.device)
        return self._tables

    def apply_device(self, rows: np.ndarray) -> np.ndarray:
        """The same contraction by K4 on the plan's device: one launch
        for every object of a (lost, helpers) group, byte axes
        concatenated; (in_rows, W) rows are copied there and the
        (out_rows, W) result back."""
        x = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.uint8))
        return bitsliced.gf_bitmatmul_stream(
            self.tables_tensor(), x.to(self.device)).cpu().numpy()

    def apply(self, rows: np.ndarray) -> np.ndarray:
        """The device contraction on the plan's device; no host fallback
        (the reference's is dropped, see the module note)."""
        return self.apply_device(rows)

    def apply_batch(self, rows_list) -> list[np.ndarray]:
        """Batched single-device apply: objects' byte axes concatenate
        into one launch, results demux per object."""
        if not rows_list:
            return []
        big, widths = concat_columns(rows_list)
        return split_columns(self.apply(big), widths)

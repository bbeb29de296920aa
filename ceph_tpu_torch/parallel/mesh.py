"""CLAY repair on the card: the port of `ClayRepairPlan` from
ceph_tpu/parallel/mesh.py.

ec/plugins/ec_clay.py's repair() is GF(2^8)-linear in the helper
symbols, so the whole coupled-layer contraction — pairwise decouple
transforms, per-plane parity-check solves in score order, final
re-coupling — collapses to ONE (sub_chunks x d*P) matrix per (lost
chunk, helper set), extracted on the host by an identity probe
(ErasureCodeClay.repair_matrix) and applied here as one GF(2^8) matrix
apply with many objects' byte axes concatenated.  On the card that apply
is K4 (`ops/bitsliced.gf_bitmatmul_stream`): the matrices are 64 x 176
at k=8 m=4 d=11 and 81 x 270 at k=8 m=3 d=10, whose product tables K1
refuses, and K4 contracts their source rows in passes that fit one
block's shared memory.

The reference module's `DistributedStripeCodec` (the sharded mesh and
its CLAY repair batch) is not ported yet; this module holds the plan
alone.

Deviation from the reference: the JAX `apply()` catches every exception
of the device apply and falls back to the host matvec.  Here `apply()`
runs on the plan's device — the card unless the plan was built with
`device="cpu"` — and swallows nothing: a failed build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..common.util import concat_columns, split_columns
from ..ec import gf
from ..ops import bitsliced


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

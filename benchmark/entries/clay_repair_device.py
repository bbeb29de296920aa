"""`clay_repair` on inputs that sit on the card: the K4 launch of
parallel/mesh.ClayRepairPlan (ops/bitsliced.gf_bitmatmul_stream on the
plan's device tables, without apply_device's host copies), the d
helpers' repair-plane rows of `objects_per_call` objects -> the lost
chunk, drawn from the seed for each call; one plan a lost chunk, all
built in set-up.  The inputs are the chunks the reference's CLAY
encoder makes of random data."""

from __future__ import annotations

import torch

from benchmark.entries.repair_device import Repair
from benchmark.harness import roofline
from benchmark.harness.entry import LOST_DRAWS, codec, lost_choices
from benchmark.reference import clay as ref_clay


class ClayRepair(Repair):

    def setup(self) -> None:
        from ceph_tpu_torch.parallel.mesh import ClayRepairPlan
        k, m, d = self.k, self.m, int(self.cfg["d"])
        plugin = codec(self.cfg, self.device)
        self.ref = ref_clay.Clay(k, m, d, self.poly, self.technique)
        sub = self.ref.sub_chunks
        if self.shard % sub:
            raise ValueError(f"shards of {self.shard} bytes do not split "
                             f"into {sub} sub-chunks")
        width = self.objects * (self.shard // sub)
        data = self._random(k, sub, width)
        self.choices = lost_choices(self.tr, k + m)
        self.lost_seq = self.rng.choice(self.choices, LOST_DRAWS).tolist()
        self.inputs = {}
        self.full = {}
        with self.by_reference():
            chunks = self.ref.encode(data)
            for lost in self.choices:
                self.inputs[lost] = self.ref.helper_rows(chunks, lost) \
                    .contiguous()
                self.full[lost] = chunks[lost].reshape(-1)
        del chunks, data
        self.tables = {lost: ClayRepairPlan.build(
            plugin, lost, device=self.device).tables_tensor()
            for lost in self.choices}
        self.rows_in = self.ref.d * len(self.ref.repair_planes(0))
        if self.control:
            ctl = ref_clay.Clay(k, m, d, self.ctl_poly, self.technique)
            self.ctl_coeff = {lost: ctl.repair_matrix(lost)
                              for lost in self.choices}

    def cost(self) -> tuple[int, int]:
        sub = self.ref.sub_chunks
        return roofline.apply_cost(sub, self.rows_in,
                                   self.objects * self.shard // sub)

    def _program(self, lost: int) -> torch.Tensor:
        from ceph_tpu_torch.ops import bitsliced as bs
        return bs.gf_bitmatmul_stream(self.tables[lost], self.inputs[lost])


ENTRY = ClayRepair

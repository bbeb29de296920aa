"""`lrc_repair` on inputs that sit on the card: the layered LRC codec's
decode_chunks_device (one K1 launch of the (helpers -> lost) plan the
codec composes from its layers), the local group's helper rows of
`objects_per_call` objects -> the lost chunk, drawn from the seed for
each call.  The inputs are the chunks the reference's layered encoder
makes of random data; each lost chunk's helpers are the program's
minimum_to_decode, checked in set-up against the reference's local
group.

The program's chunk ids are logical (data positions first, then the
others: the codec's chunk_mapping, checked against the reference's
logical_order); the reference's are positions in the mapping.

The control: a local repair is an XOR, the same in every field of
characteristic 2, so the reference's repair in the control field from
the stated field's helpers rebuilds the right bytes.  The control
therefore runs the whole code in the control field, encode and repair,
from the same data: where the lost chunk is a parity of the global
layer's or depends on one, its bytes differ."""

from __future__ import annotations

import json

from benchmark.entries.repair_device import Repair
from benchmark.harness import roofline
from benchmark.harness.entry import LOST_DRAWS, lost_choices
from benchmark.reference import gf256
from benchmark.reference import lrc as ref_lrc


class LrcRepair(Repair):

    def setup(self) -> None:
        from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
        prof = self.cfg["profile"]
        self.codec = ErasureCodePluginRegistry.instance().factory(
            self.cfg["plugin"], {"mapping": prof["mapping"],
                                 "layers": json.dumps(prof["layers"]),
                                 "device": str(self.device)})
        if not hasattr(self.codec, "decode_chunks_device"):
            raise ValueError(f"the program's {self.cfg['plugin']!r} codec "
                             f"has no device-resident decode")
        self.ref = ref_lrc.Layered(prof["mapping"], prof["layers"],
                                   self.poly, self.technique)
        n, k = self.ref.n, self.k
        if (self.ref.k, n - self.ref.k) != (k, self.m):
            raise ValueError(f"the layers make k={self.ref.k} n={n}, the "
                             f"configuration states k={k} m={self.m}")
        order = self.ref.logical_order()
        if self.codec.get_chunk_mapping() != order:
            raise ValueError(f"the program places its chunks at "
                             f"{self.codec.get_chunk_mapping()}, the "
                             f"reference at {order}")
        width = self.objects * self.shard
        data = self._random(k, width)
        with self.by_reference():
            self.full = self.ref.encode(data)[order]
        self.choices = lost_choices(self.tr, n)
        self.lost_seq = self.rng.choice(self.choices, LOST_DRAWS).tolist()
        self.survivors = {}
        self.inputs = {}
        for lost in self.choices:
            helpers = tuple(sorted(self.codec.minimum_to_decode(
                [lost], [c for c in range(n) if c != lost])))
            group = tuple(sorted(order.index(p) for p in
                                 self.ref.local_group(order[lost])))
            if helpers != group:
                raise ValueError(f"the program repairs chunk {lost} from "
                                 f"{helpers}, its local group is {group}")
            self.survivors[lost] = helpers
            self.inputs[lost] = self.full[list(helpers)].contiguous()
        self.rows_in = {len(h) for h in self.survivors.values()}
        if len(self.rows_in) != 1:
            raise ValueError(f"local groups of sizes {self.rows_in}: a "
                             f"call's cost depends on its lost chunk")
        if self.control:
            ctl = ref_lrc.Layered(prof["mapping"], prof["layers"],
                                  self.ctl_poly, self.technique)
            with self.by_reference():
                ctl_full = ctl.encode(data)[order]
            self.ctl_coeff = {}
            self.ctl_inputs = {}
            for lost in self.choices:
                self.ctl_coeff[lost] = ctl.repair_matrix(order[lost])
                self.ctl_inputs[lost] = ctl_full[
                    [order.index(p) for p in ctl.local_group(order[lost])]]
            del ctl_full
        del data

    def cost(self) -> tuple[int, int]:
        (rows_in,) = self.rows_in
        return roofline.apply_cost(1, rows_in, self.objects * self.shard)

    def call_lost(self, lost: int):
        if self.control:
            return lost, gf256.apply(self.ctl_poly, self.ctl_coeff[lost],
                                     self.ctl_inputs[lost])
        return lost, self._program(lost)

    def free_inputs(self) -> None:
        self.inputs.clear()
        if self.control:
            self.ctl_inputs.clear()


ENTRY = LrcRepair

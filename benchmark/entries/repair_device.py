"""`repair` on inputs that sit on the card:
ErasureCodeTorch.decode_chunks_device (K1 with the erasure set's cached
plan), the k survivors of `objects_per_call` objects -> the lost shard,
the lost shard drawn from the seed for each call.  The inputs are the
shards the reference's encoder makes of random data."""

from __future__ import annotations

import torch

from benchmark.harness import roofline
from benchmark.harness.entry import LOST_DRAWS, Entry, codec, lost_choices
from benchmark.reference import gf256


class Repair(Entry):
    metric = "repair_GBps"

    def setup(self) -> None:
        k, m = self.k, self.m
        self.codec = codec(self.cfg, self.device)
        width = self.objects * self.shard
        data = self._random(k, width)
        with self.by_reference():
            gen = gf256.field(self.poly).generator(self.technique, k, m)
            self.full = torch.cat([data, gf256.apply(self.poly, gen[k:],
                                                     data)])
        del data
        self.choices = lost_choices(self.tr, k + m)
        self.lost_seq = self.rng.choice(self.choices, LOST_DRAWS).tolist()
        self.survivors = {}
        self.inputs = {}
        for lost in self.choices:
            surv = tuple(i for i in range(k + m) if i != lost)[:k]
            self.survivors[lost] = surv
            self.inputs[lost] = self.full[list(surv)].contiguous()
        if self.control:
            ctl = gf256.field(self.ctl_poly)
            gen = ctl.generator(self.technique, k, m)
            self.ctl_coeff = {lost: ctl.recovery(gen, k, s, [lost])
                              for lost, s in self.survivors.items()}

    def work_bytes(self) -> int:
        return self.objects * self.shard

    def cost(self) -> tuple[int, int]:
        return roofline.apply_cost(1, self.k, self.objects * self.shard)

    def shapes(self) -> list[int]:
        return self.choices

    def call_lost(self, lost: int):
        if self.control:
            return lost, gf256.apply(self.ctl_poly, self.ctl_coeff[lost],
                                     self.inputs[lost])
        return lost, self._program(lost)

    def _program(self, lost: int) -> torch.Tensor:
        return self.codec.decode_chunks_device(
            self.inputs[lost], self.survivors[lost], (lost,))

    def call(self, i: int):
        return self.call_lost(self.lost_seq[i % LOST_DRAWS])

    def warm_call(self, shape: int):
        return self.call_lost(shape)

    def free_inputs(self) -> None:
        self.inputs.clear()

    def check(self, samples) -> dict:
        wrong = bad = 0
        for lost, out in samples:
            w = int((out.reshape(-1) != self.full[lost]).sum())
            wrong += w
            bad += int(w > 0)
        return {"rebuilt_bytes_wrong": (wrong, 0)}, bad


ENTRY = Repair

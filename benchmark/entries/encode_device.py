"""`encode` on inputs that sit on the card: K3, the write path's fused
parity and crc32c, through its wrapper ops/bitsliced.fused_hier_acc_call
with the codec's product tables, at the torch plugin's operating point,
one run an object.  That is the launch the write path makes at
combine="kernel"; the codec has no public device entry that makes it
(its `encode_extents_with_crc` stages runs from the host), so the cell
times the wrapper, not a codec method.  The calls cycle over
`pool_batches` batches of `objects_per_call` objects."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import roofline
from benchmark.harness.entry import Entry, codec
from benchmark.reference import crc32c as ref_crc
from benchmark.reference import gf256


class Encode(Entry):
    metric = "encode_GBps"

    def setup(self) -> None:
        k, m, n = self.k, self.m, self.objects
        self.codec = codec(self.cfg, self.device)
        point = self.codec.fused_point()
        self.info["operating_point"] = point
        if point["combine"] != "kernel":
            raise RuntimeError(f"the fused operating point {point} is not "
                               "K3's in-kernel fold")
        self.wb = int(point["wb"])
        block = 4 * self.wb
        if self.shard % block:
            raise ValueError(f"shards of {self.shard} bytes are not whole "
                             f"{block}-byte crc blocks")
        self.run_ends = (torch.arange(1, n + 1, dtype=torch.int64)
                         * (self.shard // block)).to(self.device)
        self.pool = [self._random(k, n * self.shard)
                     for _ in range(int(self.tr["pool_batches"]))]
        self.seeds = self.rng.integers(0, 1 << 32, (n, k + m),
                                       dtype=np.uint64)
        self.tables = self.codec._enc_tables
        if self.control:
            ctl = gf256.field(self.ctl_poly)
            self.ctl_coding = ctl.generator(self.technique, k, m)[k:]

    def work_bytes(self) -> int:
        return self.objects * self.object_bytes

    def cost(self) -> tuple[int, int]:
        return roofline.encode_cost(self.k, self.m, self.objects, self.shard)

    def shapes(self) -> list[int]:
        return list(range(len(self.pool)))

    def warm_call(self, shape: int):
        return self.call(shape)

    def call(self, i: int):
        b = i % len(self.pool)
        if self.control:
            return b, *self._control(self.pool[b])
        from ceph_tpu_torch.ops import bitsliced as bs
        parity, lacc = bs.fused_hier_acc_call(self.tables, self.pool[b],
                                              self.run_ends, self.wb)
        return b, parity, lacc

    def _per_object(self, data: torch.Tensor, parity: torch.Tensor):
        """(k+m, n*shard) shards -> (n*(k+m), shard) rows, object-major."""
        allsh = torch.cat([data, parity])
        return allsh.reshape(self.k + self.m, self.objects, self.shard) \
            .permute(1, 0, 2).reshape(-1, self.shard)

    def _control(self, data: torch.Tensor):
        parity = gf256.apply(self.ctl_poly, self.ctl_coding, data)
        lin = ref_crc.rows_linear(self._per_object(data, parity))
        return parity, lin.reshape(self.objects, self.k + self.m)

    def check(self, samples) -> dict:
        coding = gf256.field(self.poly).generator(self.technique, self.k,
                                                  self.m)[self.k:]
        par_wrong = crc_wrong = bad = 0
        seeds = self.seeds.ravel().tolist()
        for b, parity, lacc in samples:
            data = self.pool[b]
            ref_par = gf256.apply(self.poly, coding, data)
            pw = int((parity.to(data.device) != ref_par).sum())
            want = ref_crc.rows_crc(self._per_object(data, ref_par), seeds)
            got = [ref_crc.zeros(int(s), self.shard) ^ (int(v) & 0xFFFFFFFF)
                   for s, v in zip(seeds, lacc.reshape(-1).tolist())]
            cw = sum(int(a != b) for a, b in zip(got, want))
            par_wrong += pw
            crc_wrong += cw
            bad += int(pw + cw > 0)
        return {"parity_bytes_wrong": (par_wrong, 0),
                "crcs_wrong": (crc_wrong, 0)}, bad


ENTRY = Encode

"""`encode` from pageable host memory: the same objects as
encode_device, one submission an object through an ECLaunchQueue
(parallel/launch_queue) from `owners` owners, at the queue's
`window_us` and `max_bytes`."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.entries.encode_device import Encode


class EncodeHost(Encode):

    def setup(self) -> None:
        if self.control:
            raise ValueError("the control runs on cells whose inputs sit "
                             "on the card")
        super().setup()
        from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
        self.host_pool = [[b[:, o * self.shard:(o + 1) * self.shard]
                           .cpu().numpy().copy()
                           for o in range(self.objects)]
                          for b in self.pool]
        self.queue = ECLaunchQueue(device=self.device,
                                   window_us=float(self.tr["window_us"]),
                                   max_bytes=int(self.tr["max_bytes"]))
        self.owners = int(self.tr["owners"])

    def call(self, i: int):
        b = i % len(self.host_pool)
        return b, [self.queue.submit_extents(self.codec, [run],
                                             owner=o % self.owners)
                   for o, run in enumerate(self.host_pool[b])]

    def completion(self, out):
        return _Tickets(out[1])

    def finish(self, out):
        b, tickets = out
        res = [t.result()[0] for t in tickets]
        parity = torch.from_numpy(np.concatenate([r[0] for r in res], axis=1))
        lacc = torch.from_numpy(np.stack([np.asarray(r[1], dtype=np.int64)
                                          for r in res]))
        for r in res:
            if r[3] != self.shard:
                raise RuntimeError("the queue's launch left a tail to fold "
                                   "on the host")
        return b, parity, lacc

    def close(self) -> None:
        self.queue.close()


class _Tickets:
    def __init__(self, tickets):
        self.tickets = tickets

    def synchronize(self) -> None:
        for t in self.tickets:
            t.result()


ENTRY = EncodeHost

"""Example XOR codec: k=2, m=1.

The minimal correct codec used to test the interface itself, mirroring
reference src/test/erasure-code/ErasureCodeExample.h (k=2 m=1, parity =
data0 XOR data1; decode any one erasure by XOR of the other two).  The
port of ceph_tpu/ec/plugins/ec_example.py.
"""

from __future__ import annotations

import errno

import numpy as np

from ..base import ErasureCode
from ..interface import ErasureCodeError, Profile
from ..registry import ErasureCodePlugin, ErasureCodePluginRegistry

__erasure_code_version__ = ErasureCodePlugin.abi_version


class ErasureCodeExample(ErasureCode):
    k = 2
    m = 1

    def minimum_to_decode_with_cost(self, want_to_read, available):
        # Prefer the cheapest 2 chunks (reference ErasureCodeExample.h:59).
        if len(available) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough chunks")
        cheapest = sorted(available, key=lambda i: (available[i], i))[: self.k]
        return set(cheapest)

    def encode_chunks(self, chunks: np.ndarray) -> np.ndarray:
        return (chunks[0] ^ chunks[1])[None, :]

    def decode_chunks(self, dense: np.ndarray, erasures):
        out = dense.copy()
        for e in erasures:
            others = [i for i in range(3) if i != e]
            out[e] = out[others[0]] ^ out[others[1]]
        return out


class ErasureCodePluginExample(ErasureCodePlugin):
    def factory(self, profile: Profile):
        return ErasureCodeExample()


def __erasure_code_init__(name: str, directory: str | None) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginExample())

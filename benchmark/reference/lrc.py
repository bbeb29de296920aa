"""Layered locally repairable codes (Ceph's lrc plugin in its
`mapping=` / `layers=` form) in plain PyTorch: encode, each chunk's
local group, and repair.

A frozen copy of the grammar the plugin reads
(doc/rados/operations/erasure-code-lrc.rst, "Layers"), written from its
description:

* `mapping` is a string over the n chunk positions: 'D' a data chunk,
  any other letter a chunk that a layer computes.  The data chunks are
  the 'D' positions in order.
* `layers` is a list of [layer string, layer profile] pairs, applied in
  order.  A layer string is as long as the mapping; its 'D' positions
  are the layer's inputs, its 'c' positions its outputs, and '_' marks
  a position the layer leaves alone.  A layer is the systematic code
  gf256.Field.generator(technique, #D, #c) over its positions, inputs
  first, each in position order; its profile may name its own
  `technique`.  An output of one layer may be an input of a later one.
* Encode runs the layers in order.  A lost chunk is rebuilt by the
  smallest layer that holds it (the last of equal size, as upstream
  tries its layers from the last), from that layer's other positions.

Chunks are indexed by their position in the mapping, as upstream places
them.  `logical_order` gives the positions in the order a codec numbers
its chunks: the data positions, then the others, each in position
order (upstream's chunk_mapping).

Where this departs from upstream: the layers' Reed-Solomon matrix is
this repository's `reed_sol_van` construction (V inv(V[:k]) over the
configuration's field), and byte equality with upstream jerasure's
reed_sol_vandermonde_coding_matrix is not claimed.  A single-parity
layer's row is all ones in every field of characteristic 2, so a local
repair is the XOR of its group whatever the field.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf256


class Layered:
    def __init__(self, mapping: str, layers, poly: int = gf256.STATED_POLY,
                 technique: str = "reed_sol_van"):
        self.n = len(mapping)
        self.poly = poly
        self.f = gf256.field(poly)
        self.data = [p for p, ch in enumerate(mapping) if ch == "D"]
        self.k = len(self.data)
        # (input positions, output positions, (#in + #out, #in) generator)
        self.layers = []
        made = set(self.data)
        for spec, prof in layers:
            if len(spec) != self.n:
                raise ValueError(f"layer {spec!r} is not as long as the "
                                 f"mapping {mapping!r}")
            ins = [p for p, ch in enumerate(spec) if ch == "D"]
            outs = [p for p, ch in enumerate(spec) if ch == "c"]
            if not ins or not outs or not set(ins) <= made:
                raise ValueError(f"layer {spec!r} reads a chunk no earlier "
                                 f"layer made, or has no input or output")
            opts = dict(tok.split("=", 1) for tok in str(prof).split()
                        if "=" in tok)
            gen = self.f.generator(opts.get("technique", technique),
                                   len(ins), len(outs))
            self.layers.append((ins, outs, gen))
            made |= set(outs)
        if made != set(range(self.n)):
            raise ValueError(f"no layer makes positions "
                             f"{sorted(set(range(self.n)) - made)}")

    def logical_order(self) -> list[int]:
        return self.data + [p for p in range(self.n) if p not in self.data]

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """(k, N) uint8 data chunks -> (n, N), every position."""
        full = torch.zeros((self.n, data.shape[1]), dtype=torch.uint8,
                           device=data.device)
        full[self.data] = data
        for ins, outs, gen in self.layers:
            full[outs] = gf256.apply(self.poly, gen[len(ins):], full[ins])
        return full

    def _layer_of(self, lost: int):
        holding = [lay for lay in self.layers if lost in lay[0] + lay[1]]
        if not holding:
            raise ValueError(f"no layer holds position {lost}")
        size = min(len(ins) + len(outs) for ins, outs, _ in holding)
        return [lay for lay in holding
                if len(lay[0]) + len(lay[1]) == size][-1]

    def local_group(self, lost: int) -> list[int]:
        """The positions a repair of `lost` alone reads, in order."""
        ins, outs, _ = self._layer_of(lost)
        return sorted(p for p in ins + outs if p != lost)

    def repair_matrix(self, lost: int) -> np.ndarray:
        """(1, len(local_group(lost))) coefficients that rebuild `lost`
        from its local group's rows: the layer's recovery from its first
        #in other positions (in the layer's order), zero for the rest."""
        ins, outs, gen = self._layer_of(lost)
        members = ins + outs
        others = [i for i, p in enumerate(members) if p != lost]
        surv = others[:len(ins)]
        coeff = self.f.recovery(gen, len(ins), surv, [members.index(lost)])
        group = self.local_group(lost)
        out = np.zeros((1, len(group)), dtype=np.uint8)
        for j, i in enumerate(surv):
            out[0, group.index(members[i])] = coeff[0, j]
        return out

    def repair(self, rows: torch.Tensor, lost: int) -> torch.Tensor:
        """`lost` rebuilt from its local group's rows (local_group order),
        (len(group), N) -> (1, N)."""
        return gf256.apply(self.poly, self.repair_matrix(lost), rows)

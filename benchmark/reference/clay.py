"""CLAY (coupled-layer MSR) codes in plain PyTorch: encode, the
single-chunk repair layout, and repair.

A frozen copy of the construction Ceph's clay plugin implements
(src/erasure-code/clay/ErasureCodeClay.cc; Vajha et al., "Clay Codes",
FAST'18), written from these equations:

* q = d - k + 1, nu = (-(k+m)) mod q virtual zero data nodes between
  the data and the parity nodes, t = (k+m+nu) / q, and q^t sub-chunks
  (planes) a chunk, plane z = (z_0 .. z_{t-1}) at index sum z_y q^(t-1-y).
  Node i sits at (x, y) = (i mod q, i div q).
* Uncoupled symbols U form, plane by plane, codewords of the systematic
  base code (the configuration's technique, Cauchy for the port's
  plugin) of k+nu data and m parities: H U = 0 with H = [P | I].
* A node (x, y) with x != z_y pairs with (z_y, y) at z(y -> x):
  [C_A; C_B] = [[1, g], [g, 1]] [U_A; U_B], g = 2; where x == z_y, C = U.
* Encode solves the m parity nodes plane by plane in order of how many
  erased nodes are hole-aligned there (fewest first), then re-couples.
* Repair of one chunk (x0, y0) reads the q^(t-1) planes with z_y0 = x0
  from d helpers, the lost node's column partners first, then the other
  nodes in order.  Helper rows are stacked helper by helper (helpers in
  increasing id), each in increasing plane index.

Arrays are (nodes, planes, S) uint8 tensors; S runs over bytes, so one
call carries many objects side by side.  A field's products come from
reference.gf256, so the control computes the same in another field.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import gf256

GAMMA = 2


class Clay:
    def __init__(self, k: int, m: int, d: int,
                 poly: int = gf256.STATED_POLY, technique: str = "cauchy"):
        if not k < d <= k + m - 1:
            raise ValueError(f"clay needs k < d <= k+m-1, got {k} {m} {d}")
        self.k, self.m, self.d, self.poly = k, m, d, poly
        self.f = gf256.field(poly)
        self.q = d - k + 1
        self.nu = (-(k + m)) % self.q
        self.t = (k + m + self.nu) // self.q
        self.n = self.q * self.t
        self.sub_chunks = self.q ** self.t
        base = self.f.generator(technique, k + self.nu, m)
        self.H = np.concatenate([base[k + self.nu:],
                                 np.eye(m, dtype=np.uint8)], axis=1)
        self.cinv = int(self.f.inv[1 ^ int(self.f.mul[GAMMA, GAMMA])])
        self.ginv = int(self.f.inv[GAMMA])

    # -- geometry, in padded node ids ------------------------------------

    def pad_id(self, chunk: int) -> int:
        return chunk if chunk < self.k else chunk + self.nu

    def real_id(self, node: int) -> int | None:
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None
        return node - self.nu

    def xy(self, node: int) -> tuple[int, int]:
        return node % self.q, node // self.q

    def node(self, x: int, y: int) -> int:
        return y * self.q + x

    def planes(self):
        return itertools.product(range(self.q), repeat=self.t)

    def zindex(self, z) -> int:
        idx = 0
        for zy in z:
            idx = idx * self.q + zy
        return idx

    def _moved(self, z, y: int, x: int) -> int:
        z2 = list(z)
        z2[y] = x
        return self.zindex(z2)

    def _order(self, planes, erased_nodes: set[int]):
        def score(z):
            return sum(1 for e in erased_nodes
                       if z[self.xy(e)[1]] == self.xy(e)[0])
        return sorted(planes, key=lambda z: (score(z), z))

    # -- arithmetic --------------------------------------------------------

    def _mul(self, c: int, x: torch.Tensor) -> torch.Tensor:
        return gf256.mul(self.poly, c, x)

    def _decouple(self, ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
        return self._mul(self.cinv, ca ^ self._mul(GAMMA, cb))

    def _solve(self, u_known: dict, unknown: list[int]) -> dict:
        """The m unknown nodes of one plane from H u = 0."""
        a = self.H[:, unknown]
        inv = self.f.invert(a)
        some = next(iter(u_known.values()))
        rhs = []
        for r in range(self.m):
            acc = torch.zeros_like(some)
            for j, u in u_known.items():
                h = int(self.H[r, j])
                if h:
                    acc ^= self._mul(h, u)
            rhs.append(acc)
        out = {}
        for i, node in enumerate(unknown):
            acc = torch.zeros_like(some)
            for r in range(self.m):
                if inv[i, r]:
                    acc ^= self._mul(int(inv[i, r]), rhs[r])
            out[node] = acc
        return out

    # -- encode ------------------------------------------------------------

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """(k, planes, S) data -> (k+m, planes, S) chunks."""
        k, sub, s = data.shape
        if k != self.k or sub != self.sub_chunks:
            raise ValueError(f"data must be ({self.k}, {self.sub_chunks}, S)")
        c = torch.zeros((self.n, sub, s), dtype=torch.uint8,
                        device=data.device)
        c[:self.k] = data
        erased = list(range(self.k + self.nu, self.n))
        eset = set(erased)
        u = torch.zeros_like(c)
        for z in self._order(self.planes(), eset):
            zi = self.zindex(z)
            known = {}
            for ch in range(self.n):
                if ch in eset:
                    continue
                x, y = self.xy(ch)
                if z[y] == x:
                    u[ch, zi] = c[ch, zi]
                else:
                    b = self.node(z[y], y)
                    z2 = self._moved(z, y, x)
                    if b in eset:
                        u[ch, zi] = c[ch, zi] ^ self._mul(GAMMA, u[b, z2])
                    else:
                        u[ch, zi] = self._decouple(c[ch, zi], c[b, z2])
                known[ch] = u[ch, zi]
            for ch, val in self._solve(known, erased).items():
                u[ch, zi] = val
        for z in self.planes():
            zi = self.zindex(z)
            for e in erased:
                x, y = self.xy(e)
                if z[y] == x:
                    c[e, zi] = u[e, zi]
                else:
                    b = self.node(z[y], y)
                    c[e, zi] = u[e, zi] ^ self._mul(
                        GAMMA, u[b, self._moved(z, y, x)])
        return torch.cat([c[:self.k], c[self.k + self.nu:]])

    # -- repair ------------------------------------------------------------

    def repair_planes(self, lost: int) -> list[int]:
        x0, y0 = self.xy(self.pad_id(lost))
        return sorted(self.zindex(z) for z in self.planes() if z[y0] == x0)

    def helpers(self, lost: int) -> list[int]:
        """The d helper chunks, in increasing id: the lost chunk's
        column partners, then the other chunks in order."""
        _, y0 = self.xy(self.pad_id(lost))
        col = {self.real_id(self.node(x, y0)) for x in range(self.q)}
        col -= {None, lost}
        chosen = sorted(col)
        for ch in range(self.k + self.m):
            if len(chosen) >= self.d:
                break
            if ch not in col and ch != lost:
                chosen.append(ch)
        return sorted(chosen)

    def helper_rows(self, chunks: torch.Tensor, lost: int) -> torch.Tensor:
        """(k+m, planes, S) chunks -> the (d*P, S) rows a repair of
        `lost` reads."""
        planes = torch.tensor(self.repair_planes(lost), device=chunks.device)
        rows = chunks[self.helpers(lost)][:, planes]
        return rows.reshape(-1, chunks.shape[2])

    def repair(self, lost: int, rows: torch.Tensor) -> torch.Tensor:
        """The lost chunk's (planes, S) from its helpers' (d*P, S) rows."""
        helpers = self.helpers(lost)
        rp = self.repair_planes(lost)
        npl = len(rp)
        pos = {zi: i for i, zi in enumerate(rp)}
        s = rows.shape[1]
        got = {self.pad_id(h): rows[i * npl:(i + 1) * npl]
               for i, h in enumerate(helpers)}
        for v in range(self.k, self.k + self.nu):
            got[v] = torch.zeros((npl, s), dtype=torch.uint8,
                                 device=rows.device)
        lp = self.pad_id(lost)
        x0, y0 = self.xy(lp)
        column = {self.node(x, y0) for x in range(self.q)}
        erasures = column | (set(range(self.n)) - set(got) - {lp})
        order = sorted(erasures)
        out = torch.zeros((self.sub_chunks, s), dtype=torch.uint8,
                          device=rows.device)
        u: dict[tuple[int, int], torch.Tensor] = {}
        zs = self._order((z for z in self.planes() if z[y0] == x0),
                         erasures)
        for z in zs:
            zi = self.zindex(z)
            known = {}
            for ch in range(self.n):
                if ch in erasures:
                    continue
                x, y = self.xy(ch)
                cv = got[ch][pos[zi]]
                if z[y] == x:
                    known[ch] = cv
                else:
                    b = self.node(z[y], y)
                    z2 = self._moved(z, y, x)
                    if b in erasures:
                        known[ch] = cv ^ self._mul(GAMMA, u[(b, z2)])
                    else:
                        known[ch] = self._decouple(cv, got[b][pos[z2]])
            for ch, val in self._solve(known, order).items():
                u[(ch, zi)] = val
            out[zi] = u[(lp, zi)]
        for z in zs:
            zi = self.zindex(z)
            for x in range(self.q):
                if x == x0:
                    continue
                ch = self.node(x, y0)
                zp = self._moved(z, y0, x)
                ua = u[(ch, zi)]
                ub = self._mul(self.ginv, got[ch][pos[zi]] ^ ua)
                out[zp] = self._mul(GAMMA, ua) ^ ub
        return out

    def repair_matrix(self, lost: int) -> np.ndarray:
        """(planes, d*P) coefficients with lost = R x rows: the repair
        of identity rows, one byte a row."""
        j = self.d * len(self.repair_planes(lost))
        probe = torch.eye(j, dtype=torch.uint8)
        return self.repair(lost, probe).numpy()

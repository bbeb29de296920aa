"""CLAY plugin: Coupled-LAYer MSR regenerating code.

The port's copy of ceph_tpu/ec/plugins/ec_clay.py (numpy and the port's
own ec/ modules; its encode, decode and repair run on the host, as in
the JAX package), taking its GF(2^8) system solve from the port's
ec_shec as the reference does.  The device apply of its repair matrix
is parallel/mesh.ClayRepairPlan (K4).

Fills the role of reference src/erasure-code/clay/ErasureCodeClay.{h,cc}
(profile k, m, d): an MDS code with *sub-chunked* chunks whose
single-failure repair reads only a fraction 1/q of each helper chunk —
the reason ErasureCodeInterface carries sub-chunk (offset, count) lists
in minimum_to_decode (reference ErasureCodeInterface.h:297,
ErasureCodeClay.h:57 get_sub_chunk_count).

Construction (Clay codes, FAST'18 — the same family the reference
implements): nodes are points (x, y) on a q x t grid (q = d-k+1).  For
general d the grid is padded with nu = (-(k+m)) mod q VIRTUAL nodes —
zero-filled data chunks that exist only inside the codec (reference
ErasureCodeClay.cc:273 "shortened" codes); t = (k+m+nu)/q.  Real chunk
i maps to node i for i < k and i + nu otherwise.  Every chunk splits
into q^t sub-chunks indexed by planes z = (z_0..z_{t-1}), z_y in [0,q).
An uncoupled symbol U(x,y;z) per node per plane forms, within each
plane, a codeword of a scalar MDS code with m parities; the stored
(coupled) symbols C relate to U by a pairwise invertible transform:
vertex (x,y) in plane z with x != z_y pairs with vertex (z_y, y) in
plane z(y->x), and

    [ C_A@z ; C_B@z' ] = [[1, g], [g, 1]] [ U_A@z ; U_B@z' ]   (g^2 != 1)

while hole-aligned vertices (x == z_y) have C = U.

decode_layered processes planes in increasing order of "intersection
score" (count of erased hole-aligned vertices): by induction every
intact vertex can be decoupled using symbols from lower-score planes,
each plane's <= m unknown U's solve via the MDS parity-check system, and
the erased C's re-couple.  Encode IS decode with the parity chunks as
the erasures (exactly the reference's approach).

Repair: losing one chunk (x0,y0) with d helpers reads only the q^{t-1}
"repair planes" {z : z_{y0} = x0} from each helper — the bandwidth-
optimal d/(d-k+1) chunk-equivalents total.  The d < k+m-1 case adds
"aloof" survivors excluded from the helper set (reference
repair_one_lost_chunk's aloof_nodes): the per-plane erasure set is the
lost node's whole column plus the aloof nodes — exactly m unknowns —
and a helper paired with an erased/aloof vertex decouples through that
partner's already-solved U (score induction) instead of its unread C.
"""

from __future__ import annotations

import errno
import itertools

import numpy as np

from .. import gf
from ..base import ErasureCode
from ..interface import ErasureCodeError, Profile
from ..registry import ErasureCodePlugin, ErasureCodePluginRegistry

__erasure_code_version__ = ErasureCodePlugin.abi_version

GAMMA = 2  # coupling constant; needs gamma^2 != 1 in GF(2^8)


class ErasureCodeClay(ErasureCode):
    def __init__(self):
        super().__init__()
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0                       # virtual (shortening) nodes
        self.sub_chunks = 0
        self.H: np.ndarray | None = None  # (m, N) parity check of base MDS
        # cached single-failure repair matrices (the device lowering,
        # docs/REPAIR.md): (lost, helper tuple) -> (sub_chunks, d*P)
        self._repair_mats: dict[tuple, np.ndarray] = {}

    # -- setup --------------------------------------------------------------

    def init(self, profile: Profile) -> None:
        self.k = profile.to_int("k", 4)
        self.m = profile.to_int("m", 2)
        self.d = profile.to_int("d", self.k + self.m - 1)
        n = self.k + self.m
        if not self.k < self.d <= n - 1:
            raise ErasureCodeError(
                errno.EINVAL,
                f"clay: need k < d <= k+m-1 (got d={self.d}, k={self.k}, "
                f"m={self.m})")
        self.q = self.d - self.k + 1
        self.nu = (-n) % self.q
        self.t = (n + self.nu) // self.q
        self.sub_chunks = self.q ** self.t
        base = gf.cauchy_rs_matrix(self.k + self.nu, self.m)
        p = base[self.k + self.nu:]            # (m, k+nu)
        self.H = np.concatenate([p, np.eye(self.m, dtype=np.uint8)], axis=1)
        det = 1 ^ gf.gf_mul(GAMMA, GAMMA)
        self._cinv = gf.gf_inv(det)
        super().init(profile)

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunks

    def get_alignment(self) -> int:
        # chunk must split into q^t sub-chunks
        return 64 * self.sub_chunks // np.gcd(64, self.sub_chunks) \
            if self.sub_chunks % 64 else self.sub_chunks

    def get_chunk_size(self, stripe_width: int) -> int:
        per = (stripe_width + self.k - 1) // self.k
        align = self.sub_chunks
        return -(-per // align) * align

    # -- geometry (all in PADDED node ids: 0..N-1, N = q*t) -----------------

    @property
    def N(self) -> int:
        return self.q * self.t

    def _pad_id(self, chunk: int) -> int:
        """Real chunk id -> padded node id (virtual nodes sit between
        data and parity, reference ErasureCodeClay.cc:312)."""
        return chunk if chunk < self.k else chunk + self.nu

    def _real_id(self, node: int) -> int | None:
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None                   # virtual
        return node - self.nu

    def _node(self, node_id: int) -> tuple[int, int]:
        return node_id % self.q, node_id // self.q

    def _chunk(self, x: int, y: int) -> int:
        return y * self.q + x

    def _planes(self):
        return itertools.product(range(self.q), repeat=self.t)

    def _z_index(self, z: tuple[int, ...]) -> int:
        idx = 0
        for zy in z:
            idx = idx * self.q + zy
        return idx

    def _score(self, z: tuple[int, ...], erased_nodes: set) -> int:
        return sum(1 for (x, y) in erased_nodes if z[y] == x)

    # -- pair transform -----------------------------------------------------

    def _decouple(self, c_a, c_b):
        """U_A = cinv * (C_A + g*C_B) for a pair (A@z, B@z')."""
        lut = gf.mul_table()
        return lut[self._cinv][c_a ^ lut[GAMMA][c_b]]

    # -- the layered decoder ------------------------------------------------

    def _solve_plane(self, u_known: dict, unknown_nodes: list,
                     shape) -> dict:
        """Solve H u = 0 for the unknown nodes of one plane."""
        cols = [self._chunk(x, y) for (x, y) in unknown_nodes]
        a = self.H[:, cols]                          # (m, u)
        rhs = np.zeros((self.m, *shape), dtype=np.uint8)
        lut = gf.mul_table()
        for r in range(self.m):
            for j in range(self.N):
                if j in cols:
                    continue
                h = int(self.H[r, j])
                if h:
                    rhs[r] ^= lut[h][u_known[j]]
        from .ec_shec import ErasureCodeShec
        sol = ErasureCodeShec._gf_solve(
            a.astype(np.uint8), rhs.reshape(self.m, -1))
        if sol is None:
            raise ErasureCodeError(errno.EIO, "clay: plane unsolvable")
        sol = sol.reshape(len(cols), *shape)
        return {cols[i]: sol[i] for i in range(len(cols))}

    def decode_layered(self, C: np.ndarray, erased: list[int]) -> np.ndarray:
        """C: (N, sub_chunks, S) in padded node order; rows in `erased`
        (padded ids) are garbage on input, reconstructed on output."""
        S = C.shape[2]
        erased_nodes = {self._node(e) for e in erased}
        if len(erased) > self.m:
            raise ErasureCodeError(errno.EIO, "clay: too many erasures")
        out = C.copy()
        U = np.zeros_like(out)
        lut = gf.mul_table()
        erased_set = set(erased)
        planes = sorted(self._planes(),
                        key=lambda z: (self._score(z, erased_nodes), z))
        # pass A: compute U everywhere, planes in score order.  Intact
        # vertex with erased partner: partner plane has score-1 (the
        # erased partner is hole-aligned here but not there), so its U is
        # already solved — use C_A = U_A + g U_B directly and skip the
        # partner's C entirely.
        for z in planes:
            zi = self._z_index(z)
            u_known: dict[int, np.ndarray] = {}
            for ch in range(self.N):
                x, y = self._node(ch)
                if ch in erased_set:
                    continue
                if z[y] == x:
                    U[ch, zi] = out[ch, zi]
                else:
                    bch = self._chunk(z[y], y)
                    z2 = list(z)
                    z2[y] = x
                    z2i = self._z_index(tuple(z2))
                    if bch in erased_set:
                        U[ch, zi] = out[ch, zi] ^ lut[GAMMA][U[bch, z2i]]
                    else:
                        U[ch, zi] = self._decouple(out[ch, zi],
                                                   out[bch, z2i])
                u_known[ch] = U[ch, zi]
            if erased:
                sol = self._solve_plane(u_known,
                                        [self._node(e) for e in erased],
                                        (S,))
                for ch, val in sol.items():
                    U[ch, zi] = val
        # pass B: re-couple every erased vertex from the complete U field
        for z in self._planes():
            zi = self._z_index(z)
            for e in erased:
                x, y = self._node(e)
                if z[y] == x:
                    out[e, zi] = U[e, zi]
                else:
                    bch = self._chunk(z[y], y)
                    z2 = list(z)
                    z2[y] = x
                    z2i = self._z_index(tuple(z2))
                    out[e, zi] = U[e, zi] ^ lut[GAMMA][U[bch, z2i]]
        return out

    # -- codec interface ----------------------------------------------------

    def _to_planes(self, chunks: np.ndarray) -> np.ndarray:
        n_rows, cs = chunks.shape
        assert cs % self.sub_chunks == 0, (cs, self.sub_chunks)
        return chunks.reshape(n_rows, self.sub_chunks, cs // self.sub_chunks)

    def _pad_rows(self, rows: np.ndarray) -> np.ndarray:
        """(k+m, sub, S) real rows -> (N, sub, S) with zero virtual
        rows spliced between data and parity."""
        if not self.nu:
            return rows
        z = np.zeros((self.nu, *rows.shape[1:]), dtype=rows.dtype)
        return np.concatenate([rows[:self.k], z, rows[self.k:]], axis=0)

    def _strip_rows(self, rows: np.ndarray) -> np.ndarray:
        if not self.nu:
            return rows
        return np.concatenate(
            [rows[:self.k], rows[self.k + self.nu:]], axis=0)

    def encode_chunks(self, chunks: np.ndarray) -> np.ndarray:
        cs = chunks.shape[1]
        C = np.zeros((self.N, self.sub_chunks, cs // self.sub_chunks),
                     dtype=np.uint8)
        C[: self.k] = self._to_planes(chunks)
        C = self.decode_layered(
            C, list(range(self.k + self.nu, self.N)))
        return C[self.k + self.nu:].reshape(self.m, cs)

    def decode_chunks(self, dense: np.ndarray, erasures) -> np.ndarray:
        cs = dense.shape[1]
        C = self._pad_rows(self._to_planes(dense).copy())
        C = self.decode_layered(
            C, sorted({self._pad_id(e) for e in erasures}))
        return self._strip_rows(C).reshape(dense.shape[0], cs)

    # -- repair-optimal reads ----------------------------------------------

    def repair_planes(self, lost_chunk: int) -> list[int]:
        x0, y0 = self._node(self._pad_id(lost_chunk))
        return sorted(self._z_index(z) for z in self._planes()
                      if z[y0] == x0)

    def _column_chunks(self, lost_chunk: int) -> set[int]:
        """REAL ids of the lost chunk's grid column (the q-1 partners
        that must be in every helper set; virtual ids excluded)."""
        _x0, y0 = self._node(self._pad_id(lost_chunk))
        out = set()
        for x in range(self.q):
            r = self._real_id(self._chunk(x, y0))
            if r is not None and r != lost_chunk:
                out.add(r)
        return out

    def choose_helpers(self, lost_chunk: int,
                       available: set[int]) -> list[int] | None:
        """The reference's helper choice (minimum_to_repair): the lost
        node's column partners first, then fill to d from the rest.
        None if single-failure repair is not applicable."""
        col = self._column_chunks(lost_chunk)
        if not col <= available or len(available) < self.d:
            return None
        helpers = sorted(col)
        for ch in sorted(available):
            if len(helpers) >= self.d:
                break
            if ch not in col and ch != lost_chunk:
                helpers.append(ch)
        return helpers if len(helpers) == self.d else None

    def minimum_to_decode(self, want_to_read, available):
        """Single lost chunk with its column intact and >= d survivors
        -> repair planes only from d chosen helpers (the sub-chunk
        (offset,count) contract, reference minimum_to_repair)."""
        want = set(want_to_read)
        avail = set(available)
        missing = want - avail
        # repair path ONLY when the lost chunk is the sole want — the
        # reference's is_repair rejects want_to_read.size() > 1 the
        # same way (a mixed want would otherwise get a map that never
        # reads the other wanted, available chunks)
        if len(missing) == 1 and want <= missing:
            lost = next(iter(missing))
            helpers = self.choose_helpers(lost, avail - want)
            if helpers is not None:
                runs = self._runs(self.repair_planes(lost))
                return {h: list(runs) for h in helpers}
        return super().minimum_to_decode(want, avail)

    @staticmethod
    def _runs(idxs: list[int]) -> list[tuple[int, int]]:
        runs = []
        for i in idxs:
            if runs and runs[-1][0] + runs[-1][1] == i:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((i, 1))
        return [tuple(r) for r in runs]

    def repair(self, lost_chunk: int,
               helper_planes: dict[int, np.ndarray],
               sub_size: int) -> np.ndarray:
        """Rebuild `lost_chunk` from exactly d helpers' repair-plane
        sub-chunks.

        helper_planes: real chunk_id -> (len(repair_planes), sub_size)
        array, rows ordered like repair_planes(lost_chunk).  Survivors
        NOT in helper_planes are "aloof": their symbols are never read
        and their per-plane U's are solved as unknowns (reference
        repair_one_lost_chunk).  Returns the full chunk.
        """
        lost = self._pad_id(lost_chunk)
        x0, y0 = self._node(lost)
        rp = self.repair_planes(lost_chunk)
        rp_pos = {zi: i for i, zi in enumerate(rp)}
        if len(helper_planes) != self.d:
            raise ErasureCodeError(
                errno.EIO, f"clay: need exactly d={self.d} helpers "
                f"(got {len(helper_planes)})")
        if not self._column_chunks(lost_chunk) <= set(helper_planes):
            raise ErasureCodeError(
                errno.EIO, "clay: helper set must include the lost "
                "chunk's column partners")
        lut = gf.mul_table()
        # padded helper table; virtual nodes are zero-filled helpers
        helpers = {self._pad_id(ch): arr
                   for ch, arr in helper_planes.items()}
        for v in range(self.k, self.k + self.nu):
            helpers[v] = np.zeros((len(rp), sub_size), dtype=np.uint8)
        # erasure set per plane: the lost column + aloof survivors —
        # exactly m unknowns (q + (k+m-d-1) = m)
        column = {self._chunk(x, y0) for x in range(self.q)}
        aloof = set(range(self.N)) - set(helpers) - {lost}
        erasures = column | aloof
        erased_nodes = {self._node(e) for e in erasures}
        out = np.zeros((self.sub_chunks, sub_size), dtype=np.uint8)
        U: dict[tuple[int, int], np.ndarray] = {}  # (node, zi) -> U
        planes = sorted((z for z in self._planes() if z[y0] == x0),
                        key=lambda z: (self._score(z, erased_nodes), z))
        for z in planes:
            zi = self._z_index(z)
            u_known: dict[int, np.ndarray] = {}
            for ch in range(self.N):
                if ch in erasures:
                    continue
                x, y = self._node(ch)
                cv = helpers[ch][rp_pos[zi]]
                if z[y] == x:
                    u_known[ch] = cv
                else:
                    bch = self._chunk(z[y], y)
                    z2 = list(z)
                    z2[y] = x
                    z2i = self._z_index(tuple(z2))
                    if bch in erasures:
                        # partner unread: decouple via its U, solved in
                        # a lower-score plane (score induction — bch is
                        # hole-aligned at z, not at z2)
                        u_known[ch] = cv ^ lut[GAMMA][U[(bch, z2i)]]
                    else:
                        u_known[ch] = self._decouple(
                            cv, helpers[bch][rp_pos[z2i]])
            sol = self._solve_plane(
                u_known, [self._node(e) for e in erasures], (sub_size,))
            for ch, val in sol.items():
                U[(ch, zi)] = val
            out[zi] = sol[lost]                 # hole-aligned: C = U
        # non-repair planes of the lost chunk via the coupling relation:
        # lost node B at z' pairs with A=(x,y0) at z = z'(y0->x0), z in rp
        ginv = gf.gf_inv(GAMMA)
        for z in planes:
            zi = self._z_index(z)
            for x in range(self.q):
                if x == x0:
                    continue
                ch = self._chunk(x, y0)
                zprime = list(z)
                zprime[y0] = x
                zpi = self._z_index(tuple(zprime))
                u_a = U[(ch, zi)]               # column U: plane-solved
                if ch in helpers:
                    c_a = helpers[ch][rp_pos[zi]]
                    # C_A@z = U_A + g U_B  ->  U_B = (C_A + U_A)/g
                    u_b = lut[ginv][c_a ^ u_a]
                else:
                    raise ErasureCodeError(
                        errno.EIO, "clay: column partner missing")
                # C_B@z' = g U_A + U_B
                out[zpi] = lut[GAMMA][u_a] ^ u_b
        return out.reshape(-1)

    # -- device lowering: repair as ONE GF(2^8) matrix -----------------------
    #
    # Every step of repair() is GF(2^8)-linear in the helper symbols:
    # the pairwise decouple transform is a constant 2x2 GF matrix, the
    # per-plane solve inverts a system whose coefficient matrix depends
    # only on the erasure pattern (never the data), and the final
    # re-coupling is again constant gf_muls and XORs.  The whole
    # coupled-layer contraction therefore collapses to a single
    # (sub_chunks x d*P) matrix R over GF(2^8) applied to the stacked
    # helper repair-plane symbols — which is exactly the shape the
    # TPU/mesh data plane wants: one batched GF matmul per
    # (lost, helpers) group, objects concatenated along the byte axis
    # (parallel/mesh.py ClayRepairPlan / clay_repair_batch).  R is
    # extracted by probing repair() with an identity payload: helper
    # h's plane row p carries unit vector e_{h*P+p} (sub_size = d*P),
    # so the output IS the matrix, in one host repair call.

    def repair_helper_order(self, lost_chunk: int,
                            helper_ids=None) -> tuple[int, ...]:
        """Canonical helper row order of the repair matrix (sorted
        real chunk ids); helper h at index hi owns input rows
        [hi*P, (hi+1)*P)."""
        if helper_ids is None:
            helper_ids = self.choose_helpers(
                lost_chunk,
                set(range(self.get_chunk_count())) - {lost_chunk})
            if helper_ids is None:
                raise ErasureCodeError(
                    errno.EIO, f"clay: no helper set for {lost_chunk}")
        return tuple(sorted(helper_ids))

    def repair_matrix(self, lost_chunk: int,
                      helper_ids=None) -> np.ndarray:
        """(sub_chunks, d*P) GF(2^8) matrix R with
        rebuilt_chunk = R @ rows, rows[hi*P + p] = helper hi's p-th
        repair-plane sub-chunk (repair_helper_order order).  Cached
        per (lost, helpers) — the plane-by-plane host solver runs once
        per geometry, every later repair is a matmul."""
        helpers = self.repair_helper_order(lost_chunk, helper_ids)
        key = (lost_chunk, helpers)
        hit = self._repair_mats.get(key)
        if hit is not None:
            return hit
        P = len(self.repair_planes(lost_chunk))
        J = self.d * P
        probes = {}
        for hi, ch in enumerate(helpers):
            arr = np.zeros((P, J), dtype=np.uint8)
            arr[np.arange(P), hi * P + np.arange(P)] = 1
            probes[ch] = arr
        mat = self.repair(lost_chunk, probes, J) \
            .reshape(self.sub_chunks, J)
        self._repair_mats[key] = mat
        return mat

    def repair_rows(self, lost_chunk: int,
                    helper_planes: dict[int, np.ndarray],
                    helper_ids=None) -> np.ndarray:
        """Stack a repair() helper dict into the (d*P, sub_size) row
        layout repair_matrix expects."""
        helpers = self.repair_helper_order(
            lost_chunk, helper_ids if helper_ids is not None
            else helper_planes.keys())
        return np.concatenate(
            [np.asarray(helper_planes[ch], dtype=np.uint8)
             for ch in helpers], axis=0)

    def repair_signature(self, lost_chunk: int,
                         helper_ids=None) -> tuple:
        """Cache/coalescing key of one repair plan: geometry +
        (lost, helpers) fully determine the matrix (the base MDS
        parity check is derived from (k+nu, m) deterministically)."""
        return ("clay", self.k, self.m, self.d, lost_chunk,
                self.repair_helper_order(lost_chunk, helper_ids))


class ErasureCodePluginClay(ErasureCodePlugin):
    def factory(self, profile: Profile):
        return ErasureCodeClay()


def __erasure_code_init__(name: str, directory: str | None) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginClay())

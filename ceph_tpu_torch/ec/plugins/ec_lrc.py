"""LRC plugin: Locally Repairable Code.

The port's copy of ceph_tpu/ec/plugins/ec_lrc.py (numpy and the port's
own ec/ modules and registry; encode and decode run on the host, as in
the JAX package).  The layers of the layered grammar default to the
port's `jerasure` plugin, on the native library.

Fills the role of reference src/erasure-code/lrc/ErasureCodeLrc.{h,cc}:
cheap single-failure repair by adding local parities over groups.

Two profile forms, like the reference:

1. k/m/l (doc/rados/operations/erasure-code-lrc.rst "low-level"): k
   data chunks, m global RS parities, and one local XOR parity per
   group of l chunks over the ordered [data..., global parities...]
   sequence.
2. layers=/mapping= (reference ErasureCodeLrc.h:61): the recursive
   grammar.  mapping= is a string over the physical chunk positions
   ('D' = user data, anything else = derived); layers= is a JSON list
   of [layer_string, layer_profile] pairs, each layer running its own
   plugin (default jerasure) whose data inputs are the positions its
   string marks 'D' and whose coding outputs are the positions marked
   'c'.  Earlier layers' outputs may feed later layers' inputs; decode
   iterates layers, repairing locally wherever a single layer can.

minimum_to_decode prefers the smallest repair set — the property LRC
exists for.
"""

from __future__ import annotations

import errno
import json

import numpy as np

from .. import gf
from ..base import ErasureCode
from ..interface import ErasureCodeError, Profile
from ..registry import ErasureCodePlugin, ErasureCodePluginRegistry

__erasure_code_version__ = ErasureCodePlugin.abi_version


class ErasureCodeLrc(ErasureCode):
    ALLOW_PARTIAL_DECODE = True

    def __init__(self):
        super().__init__()
        self.l = 0
        self.n_local = 0
        self.global_matrix: np.ndarray | None = None
        self.groups: list[list[int]] = []  # member chunk ids per group

    def init(self, profile: Profile) -> None:
        self.k = profile.to_int("k", 4)
        m = profile.to_int("m", 2)
        self.l = profile.to_int("l", 3)
        if self.k < 1 or m < 1 or self.l < 2:
            raise ErasureCodeError(errno.EINVAL,
                                   f"bad k={self.k} m={m} l={self.l}")
        if (self.k + m) % self.l:
            raise ErasureCodeError(
                errno.EINVAL,
                f"k+m={self.k + m} must be divisible by l={self.l}")
        self._m_global = m
        self.n_local = (self.k + m) // self.l
        self.m = m + self.n_local  # interface m = all parity chunks
        self.global_matrix = gf.cauchy_rs_matrix(self.k, m)
        # groups over the ordered [data, global parity] sequence; the
        # local parity chunk of group g sits at index k + m + g
        self.groups = []
        for g in range(self.n_local):
            members = list(range(g * self.l, (g + 1) * self.l))
            self.groups.append(members)
        super().init(profile)

    # -- geometry -----------------------------------------------------------

    def group_of(self, chunk: int) -> list[int] | None:
        """Group members + local parity for a data/global chunk id."""
        km = self.k + self._m_global
        if chunk < km:
            g = chunk // self.l
            return self.groups[g] + [km + g]
        if chunk < self.get_chunk_count():
            g = chunk - km
            return self.groups[g] + [km + g]
        return None

    # -- codec --------------------------------------------------------------

    def encode_chunks(self, chunks: np.ndarray) -> np.ndarray:
        glob = gf.gf_matvec(self.global_matrix[self.k:], chunks)
        seq = np.concatenate([chunks, glob], axis=0)
        locals_ = np.stack([
            np.bitwise_xor.reduce(seq[members], axis=0)
            for members in self.groups])
        return np.concatenate([glob, locals_], axis=0)

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        missing = want - avail
        if not missing:
            return {i: [(0, 1)] for i in want}
        if len(missing) == 1:
            # local repair: the group of the missing chunk
            mchunk = next(iter(missing))
            grp = self.group_of(mchunk)
            if grp is not None:
                helpers = [c for c in grp if c != mchunk]
                if all(h in avail for h in helpers):
                    out = {h: [(0, 1)] for h in helpers}
                    for w in want & avail:
                        out[w] = [(0, 1)]
                    return out
        # global: any k of the data+global chunks
        km = self.k + self._m_global
        usable = sorted(a for a in avail if a < km)
        if len(usable) < self.k:
            raise ErasureCodeError(
                errno.EIO, f"LRC cannot decode: {sorted(avail)}")
        out = {c: [(0, 1)] for c in usable[: self.k]}
        for w in want & avail:
            out[w] = [(0, 1)]
        return out

    def decode_chunks(self, dense: np.ndarray, erasures) -> np.ndarray:
        out = dense.copy()
        erased = set(erasures)
        km = self.k + self._m_global
        # pass 1: local XOR repairs while possible
        progress = True
        while progress and erased:
            progress = False
            for e in sorted(erased):
                grp = self.group_of(e)
                if grp is None:
                    continue
                helpers = [c for c in grp if c != e]
                if all(h not in erased for h in helpers):
                    out[e] = np.bitwise_xor.reduce(out[helpers], axis=0)
                    erased.discard(e)
                    progress = True
        self._unsolved = set()
        if not erased:
            return out
        # pass 2: global RS over data+global parities
        survivors = [i for i in range(km) if i not in erased][: self.k]
        if len(survivors) < self.k:
            # partial helper set: whatever pass 1 recovered is all we
            # can do; decode() errors if a wanted chunk is still missing
            self._unsolved = set(erased)
            return out
        inv = gf.gf_invert_matrix(self.global_matrix[survivors, :])
        need_data = [e for e in erased if e < self.k]
        if need_data:
            rows = np.stack([inv[e] for e in need_data])
            rec = gf.gf_matvec(rows, out[survivors])
            for idx, e in enumerate(need_data):
                out[e] = rec[idx]
            erased -= set(need_data)
        # re-derive any remaining parity chunks from complete data
        if erased:
            glob = gf.gf_matvec(self.global_matrix[self.k:], out[: self.k])
            out[self.k:km] = glob
            seq = out[:km]
            for g, members in enumerate(self.groups):
                out[km + g] = np.bitwise_xor.reduce(seq[members], axis=0)
        return out

    def decode(self, want_to_read, chunks, chunk_size):
        self._unsolved = set()   # base may shortcut past decode_chunks
        out = super().decode(want_to_read, chunks, chunk_size)
        bad = set(want_to_read) & self._unsolved
        if bad:
            raise ErasureCodeError(
                errno.EIO,
                f"LRC: chunks {sorted(bad)} unrecoverable from provided set")
        return out


class _Layer:
    """One grammar layer: a sub-codec over a subset of positions."""

    def __init__(self, spec: str, prof_str: str, phys2log: dict[int, int]):
        self.spec = spec
        try:
            self.d_rows = [phys2log[p] for p, ch in enumerate(spec)
                           if ch == "D"]
            self.c_rows = [phys2log[p] for p, ch in enumerate(spec)
                           if ch == "c"]
        except KeyError as e:
            raise ErasureCodeError(
                errno.EINVAL, f"layer {spec!r} indexes beyond the "
                f"mapping: {e}") from e
        if not self.d_rows or not self.c_rows:
            raise ErasureCodeError(
                errno.EINVAL, f"layer {spec!r} needs both D and c")
        prof = {"plugin": "jerasure"}
        for tok in prof_str.split():
            if "=" in tok:
                key, val = tok.split("=", 1)
                prof[key] = val
        prof["k"] = str(len(self.d_rows))
        prof["m"] = str(len(self.c_rows))
        plugin = prof.pop("plugin")
        self.codec = ErasureCodePluginRegistry.instance().factory(
            plugin, Profile(prof))
        self.rows = self.d_rows + self.c_rows   # sub logical order

    def members(self) -> list[int]:
        return self.rows


class ErasureCodeLrcLayered(ErasureCode):
    """The layers=/mapping= grammar (reference ErasureCodeLrc.cc
    parse_kml's general path + layers_description/layers_init)."""

    ALLOW_PARTIAL_DECODE = True

    def init(self, profile: Profile) -> None:
        mapping = profile.get("mapping") or ""
        try:
            layer_list = json.loads(profile.get("layers") or "[]")
        except ValueError as e:
            raise ErasureCodeError(errno.EINVAL,
                                   f"bad layers JSON: {e}") from e
        if not mapping or not layer_list:
            raise ErasureCodeError(errno.EINVAL,
                                   "layered LRC needs mapping= and layers=")
        n = len(mapping)
        data_pos = [p for p, ch in enumerate(mapping) if ch == "D"]
        if not data_pos:
            raise ErasureCodeError(errno.EINVAL,
                                   f"mapping {mapping!r} has no D")
        self.k = len(data_pos)
        self.m = n - self.k
        # logical order: data chunks (mapping D's) then derived chunks;
        # chunk_mapping records the physical position of each logical id
        # (the placement contract of get_chunk_mapping)
        other_pos = [p for p in range(n) if mapping[p] != "D"]
        self.chunk_mapping = data_pos + other_pos
        phys2log = {p: i for i, p in enumerate(self.chunk_mapping)}
        self.layers: list[_Layer] = []
        computed = set(range(self.k))
        for ent in layer_list:
            spec, prof_str = (ent[0], ent[1] if len(ent) > 1 else "")
            if len(spec) != n:
                raise ErasureCodeError(
                    errno.EINVAL,
                    f"layer {spec!r} length != mapping length {n}")
            layer = _Layer(spec, prof_str, phys2log)
            clobbers = [r for r in layer.c_rows if r < self.k]
            if clobbers:
                raise ErasureCodeError(
                    errno.EINVAL,
                    f"layer {spec!r} writes coding output over data "
                    f"positions {clobbers}")
            missing_inputs = set(layer.d_rows) - computed
            if missing_inputs:
                raise ErasureCodeError(
                    errno.EINVAL,
                    f"layer {spec!r} consumes chunks no earlier layer "
                    f"produced: logical {sorted(missing_inputs)}")
            computed |= set(layer.c_rows)
            self.layers.append(layer)
        uncovered = set(range(n)) - computed
        if uncovered:
            raise ErasureCodeError(
                errno.EINVAL,
                f"no layer produces logical chunks {sorted(uncovered)}")
        self.profile = profile

    # -- codec ---------------------------------------------------------------

    def encode_chunks(self, chunks: np.ndarray) -> np.ndarray:
        n = self.get_chunk_count()
        full = np.zeros((n, chunks.shape[1]), dtype=np.uint8)
        full[: self.k] = chunks
        for layer in self.layers:
            parity = np.asarray(
                layer.codec.encode_chunks(full[layer.d_rows]))
            for i, row in enumerate(layer.c_rows):
                full[row] = parity[i]
        return full[self.k:]

    def decode_chunks(self, dense: np.ndarray, erasures) -> np.ndarray:
        out = dense.copy()
        erased = set(erasures)
        progress = True
        while erased and progress:
            progress = False
            for layer in self.layers:
                rows = layer.members()
                gone = [r for r in rows if r in erased]
                if not gone or \
                        len(gone) > layer.codec.get_coding_chunk_count():
                    continue
                sub = out[rows]
                sub_erasures = [rows.index(r) for r in gone]
                try:
                    rebuilt = np.asarray(layer.codec.decode_chunks(
                        sub, sub_erasures))
                except ErasureCodeError:
                    continue
                for i, r in enumerate(rows):
                    out[r] = rebuilt[i]
                erased -= set(gone)
                progress = True
        self._unsolved = set(erased)
        return out

    def minimum_to_decode(self, want_to_read, available):
        want, avail = set(want_to_read), set(available)
        missing = want - avail
        if not missing:
            return {i: [(0, 1)] for i in want}
        helpers: set[int] = set(want & avail)
        for mchunk in missing:
            best = None
            for layer in self.layers:
                rows = set(layer.members())
                if mchunk not in rows:
                    continue
                others = rows - {mchunk}
                # a layer only repairs from chunks that actually exist
                if others <= avail and (best is None or
                                        len(others) < len(best)):
                    best = others
            if best is None:
                # no single layer repairs it: offer everything we have
                # (the iterative decode may still chain layers)
                return {i: [(0, 1)] for i in avail}
            helpers |= best
        return {i: [(0, 1)] for i in helpers}

    def decode(self, want_to_read, chunks, chunk_size):
        # reset per call: the base class shortcuts past decode_chunks
        # when everything wanted is present, which must not read a
        # PREVIOUS failed decode's unsolved set
        self._unsolved = set()
        out = super().decode(want_to_read, chunks, chunk_size)
        bad = set(want_to_read) & self._unsolved
        if bad:
            raise ErasureCodeError(
                errno.EIO,
                f"LRC: chunks {sorted(bad)} unrecoverable from provided set")
        return out


class ErasureCodePluginLrc(ErasureCodePlugin):
    def factory(self, profile: Profile):
        if profile.get("layers") or profile.get("mapping"):
            return ErasureCodeLrcLayered()
        return ErasureCodeLrc()


def __erasure_code_init__(name: str, directory: str | None) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginLrc())

"""GPU erasure-code plugin ("torch"): GF(2^8) Reed-Solomon on CUDA.

The PyTorch/CUDA counterpart of ceph_tpu's "jax" plugin: fills the
same registry seam, with encode/decode and the fused parity+crc32c
launch running as the hand-written kernels of ops/bitsliced.py.
Parity is bit-identical to the jax and CPU plugins because every side
uses the same generator matrices (ec/gf.py).

Techniques: `cauchy` (default) and `reed_sol_van`.

Profile key `device` picks where the codec runs: "cuda" (default) or
"cpu" (the plain PyTorch versions — the tests' setting).  A CUDA
request without a GPU raises at init.

The fused write path runs at the operating point ops/autotune picks for
the card (`fused_point`, swept and cached at the first fused encode).
`_use_w32` (ceph_tpu's attribute of the same name, True here on every
device) picks the branch: False takes the write path's byte branch
(K2's byte entry at 2 KiB tiles, path "bytes"), and the operating point
is then not consulted.
The device-resident entries (`encode_chunks_device`, `encode_stripes`,
`decode_chunks_device`, `encode_words_with_crc`) take and return
tensors on the codec's device, with no host staging: the contract of
Pallas kernel #5 (`_gf_kernel`), served by K1.

Decode: the (survivors -> erased) coefficient matrix is computed on the
host (Gauss-Jordan, cached by erasure signature like the reference's
ISA-L table cache) and applied with the same K1 kernel as encode.
"""

from __future__ import annotations

import errno
import sys
import threading

import numpy as np
import torch

from ... import resolve_device
from ...ops import bitsliced as bs
from ...ops import crc32c_linear as cl
from .. import gf
from ..base import ErasureCode
from ..interface import ErasureCodeError, Profile
from ..registry import ErasureCodePlugin, ErasureCodePluginRegistry

# the kernels and the int32 word views of the plain crc path read bytes
# as little-endian words
assert sys.byteorder == "little", "ec_torch assumes a little-endian host"

__erasure_code_version__ = ErasureCodePlugin.abi_version


class ErasureCodeTorch(ErasureCode):
    technique = "cauchy"

    def __init__(self, technique: str = "cauchy"):
        super().__init__()
        self.technique = technique
        self.matrix: np.ndarray | None = None
        self.device = None
        self._codec_sig: tuple | None = None
        self._enc_tables = None            # (m, k, 256) on self.device
        self._fused_point: dict | None = None   # lazy autotune result
        self._use_w32 = True        # False: the write path's byte branch
        self._decode_cache: dict[tuple, tuple] = {}
        self._lock = threading.Lock()

    # -- setup --------------------------------------------------------------

    def init(self, profile: Profile) -> None:
        self.k = profile.to_int("k", 8)
        self.m = profile.to_int("m", 3)
        if self.k < 1 or self.m < 1 or self.k + self.m > gf.GF_SIZE:
            raise ErasureCodeError(errno.EINVAL, f"bad k={self.k} m={self.m}")
        self.device = resolve_device(profile.get("device") or "cuda")
        if self.technique == "reed_sol_van":
            matrix = gf.vandermonde_rs_matrix(self.k, self.m)
        else:
            matrix = gf.cauchy_rs_matrix(self.k, self.m)
        self.set_matrix(matrix)
        super().init(profile)

    def set_matrix(self, matrix: np.ndarray) -> None:
        """Install a (k+m, k) systematic generator matrix (and drop any
        decode plans built from an earlier one)."""
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        if matrix.shape != (self.k + self.m, self.k):
            raise ErasureCodeError(
                errno.EINVAL, f"generator matrix {matrix.shape} does not "
                f"fit k={self.k} m={self.m}")
        self.matrix = matrix
        self._codec_sig = None
        self._enc_tables = bs.tables_tensor(
            gf.product_tables(matrix[self.k:]), self.device)
        with self._lock:
            self._decode_cache.clear()

    def get_alignment(self) -> int:
        return 64

    def codec_signature(self) -> tuple:
        """Coalescing key: two instances with equal signatures produce
        bit-identical parity through the same launch paths."""
        if self._codec_sig is None:
            a = np.ascontiguousarray(self.matrix)
            self._codec_sig = ("torch", int(self.k), int(self.m), a.shape,
                               a.tobytes())
        return self._codec_sig

    # -- encode -------------------------------------------------------------

    def _apply_bitmat(self, tables, chunks: np.ndarray) -> np.ndarray:
        """Synchronous K1 apply of (r, k, 256) tables to host chunks."""
        _staged, dev = bs.stage(chunks, self.device)
        return bs.gf_bitmatmul(tables, dev).cpu().numpy()

    def encode_chunks(self, chunks: np.ndarray) -> np.ndarray:
        return self._apply_bitmat(self._enc_tables,
                                  np.ascontiguousarray(chunks, np.uint8))

    def encode_chunks_device(self, chunks: torch.Tensor) -> torch.Tensor:
        """Device-resident encode: (k, N) uint8 on the codec's device ->
        (m, N) parity, one K1 launch, any N.  No host transfer; for
        benchmarks and pipelines holding device tensors."""
        return bs.gf_bitmatmul(self._enc_tables, chunks)

    def encode_stripes(self, stripes: torch.Tensor) -> torch.Tensor:
        """Batched encode: (B, k, C) uint8 on the device -> (B, m, C) in
        one K1 launch.  The batch rides the byte axis: the stripes are
        laid out as (k, B*C) so every stripe's chunk j lands in row j.
        Returns a permuted view of the (m, B*C) launch output."""
        b, k, c = stripes.shape
        if k != self.k:
            raise ValueError(f"stripes have k={k}, the codec k={self.k}")
        flat = stripes.permute(1, 0, 2).reshape(k, b * c)
        par = bs.gf_bitmatmul(self._enc_tables, flat)
        return par.reshape(self.m, b, c).permute(1, 0, 2)

    def fused_point(self) -> dict:
        """The fused write path's (tile, wb, extract, combine) operating
        point for this device, resolved lazily through the ops/autotune
        cache: the first fused call on a fresh card pays the sweep and
        CPU devices get the static default.  A kernel that fails to
        build or launch in the sweep raises here, failing the write,
        rather than moving the path onto its plain version."""
        if self._fused_point is None:
            from ...ops import autotune
            self._fused_point = autotune.fused_operating_point(
                self.k, self.m, tables=self._enc_tables,
                mat=self.matrix[self.k:])
        return self._fused_point

    def encode_words_with_crc(self, chunks: torch.Tensor):
        """Device-resident fused parity + crc at the operating point:
        chunks (k, N) uint8 on the codec's device, N a multiple of the
        point's crc block (4*wb bytes).  Returns (parity (m, N) uint8,
        L (k+m,) int64 — ONE combined L per shard; fold with
        crc32c_linear.fold_run_crc)."""
        point = self.fused_point()
        return bs.gf_encode_with_crc_w32_fold(
            self._enc_tables, chunks, point["wb"], point["combine"])

    def _point_kwargs(self) -> dict:
        if not self._use_w32:
            return {"use_w32": False}
        point = self.fused_point()
        return {"tile": point["tile"], "wb": point["wb"],
                "combine": point["combine"], "use_w32": True}

    def encode_extents_with_crc(self, runs: list[np.ndarray]):
        """Parity + ONE combined crc L per shard for every run of a
        drain, at the operating point: per run (parity (m, Wi), l (k+m,)
        uint32, tail_bytes, body_bytes); fold each with
        fold_extent_crcs."""
        return bs.gf_encode_extents_with_crc(self._enc_tables, runs,
                                             **self._point_kwargs())

    def encode_extents_with_crc_submit(self, runs: list[np.ndarray]):
        """Dispatch half of encode_extents_with_crc for the dispatch-ahead
        pipeline: launches the drain's fused work and returns a handle
        holding a CUDA event — the caller does not wait for the card."""
        return bs.gf_encode_extents_with_crc_submit(self._enc_tables, runs,
                                                    **self._point_kwargs())

    def encode_extents_with_crc_finalize(self, handle):
        """Completion half: waits for one submit handle's event and
        returns the per-run (parity, l, tail, body_bytes) tuples."""
        return bs.gf_encode_extents_with_crc_finalize(handle)

    def encode_chunks_submit(self, chunks: np.ndarray):
        """Plain-parity dispatch half (no crc) for overwrite extents:
        launch the encode of (k, N) uint8 chunks, queue the copy back,
        and return a handle without waiting."""
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        staged, dev = bs.stage(chunks, self.device)
        par = bs.gf_bitmatmul(self._enc_tables, dev)
        return ("torch", staged, bs.to_host_async(par),
                bs.record_event(self.device))

    def encode_chunks_finalize(self, handle) -> np.ndarray:
        _, _staged, host, event = handle
        bs.wait(event)
        return host.numpy()

    def fold_extent_crcs(self, l, tail_bytes, seeds: list[int],
                         body_bytes: int) -> list[int]:
        """Host fold of one run's combined L-vectors into cumulative
        shard crcs with per-shard seeds (the hinfo chain): one
        seed-advance plus the sub-block tail per shard."""
        return [cl.fold_run_crc(int(l[s]), body_bytes, seeds[s],
                                tail_bytes[s].tobytes())
                for s in range(self.k + self.m)]

    def encode_chunks_with_crc(self, chunks: np.ndarray,
                               seeds: list[int] | None = None
                               ) -> tuple[np.ndarray, list[int]]:
        """Parity AND per-shard crc32c from one fused launch.  Returns
        (parity (m, N), crcs of all k+m shards seeded `seeds`, default
        0xFFFFFFFF each — the HashInfo convention)."""
        chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
        if seeds is None:
            seeds = [0xFFFFFFFF] * (self.k + self.m)
        [(parity, l, tail_bytes, body_bytes)] = \
            self.encode_extents_with_crc([chunks])
        crcs = self.fold_extent_crcs(l, tail_bytes, seeds, body_bytes)
        return np.asarray(parity), crcs

    # -- decode -------------------------------------------------------------

    def _decode_plan(self, survivors: tuple[int, ...],
                     targets: tuple[int, ...]):
        """(survivors -> targets) GF matrix + its product tables on the
        device, cached by signature (reference ErasureCodeIsaTableCache
        role)."""
        key = (survivors, targets)
        with self._lock:
            hit = self._decode_cache.get(key)
        if hit is not None:
            return hit
        coeff = gf.recovery_matrix(self.matrix, self.k, survivors, targets)
        plan = (coeff, bs.tables_tensor(gf.product_tables(coeff),
                                        self.device))
        with self._lock:
            self._decode_cache[key] = plan
        return plan

    def decode_chunks_device(self, chunks: torch.Tensor, survivors,
                             targets) -> torch.Tensor:
        """Device-resident decode: `chunks` (k, N) survivor rows in
        `survivors` order on the codec's device -> the reconstructed
        `targets` rows (len(targets), N), one K1 launch."""
        _, tables = self._decode_plan(tuple(survivors), tuple(targets))
        return bs.gf_bitmatmul(tables, chunks)

    def decode_chunks(self, dense: np.ndarray, erasures) -> np.ndarray:
        n = self.get_chunk_count()
        erased = tuple(sorted(set(erasures)))
        survivors = tuple(i for i in range(n)
                          if i not in set(erased))[: self.k]
        if len(survivors) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough survivors")
        _, tables = self._decode_plan(survivors, erased)
        rec = self._apply_bitmat(
            tables, np.ascontiguousarray(dense[list(survivors)], np.uint8))
        out = dense.copy()
        for idx, e in enumerate(erased):
            out[e] = rec[idx]
        return out


def from_jax_state(jax_codec, device: str = "cuda") -> ErasureCodeTorch:
    """A torch codec carrying the state of a ceph_tpu jax codec: its
    generator matrix (`ErasureCodeJax.matrix`, numpy uint8) and its
    cached decode plans (survivors, targets) -> coefficients.  Takes
    plain attributes only, so this module imports nothing of JAX.  The
    jax codec's `_fused_point` is not carried: it is an operating point
    of a TPU; this codec resolves its own through ops/autotune."""
    codec = ErasureCodeTorch(getattr(jax_codec, "technique", "cauchy"))
    codec.k = int(jax_codec.k)
    codec.m = int(jax_codec.m)
    codec.device = resolve_device(device)
    codec.profile = Profile({"k": str(codec.k), "m": str(codec.m),
                             "device": str(device),
                             "technique": codec.technique})
    codec.set_matrix(np.asarray(jax_codec.matrix, dtype=np.uint8))
    for (survivors, targets), plan in dict(
            getattr(jax_codec, "_decode_cache", {})).items():
        coeff = np.asarray(plan[0], dtype=np.uint8)
        codec._decode_cache[(tuple(survivors), tuple(targets))] = (
            coeff, bs.tables_tensor(gf.product_tables(coeff), codec.device))
    return codec


class ErasureCodePluginTorch(ErasureCodePlugin):
    def factory(self, profile: Profile):
        technique = profile.get("technique", "cauchy") or "cauchy"
        if technique not in ("cauchy", "reed_sol_van"):
            raise ErasureCodeError(
                errno.ENOENT, f"unknown torch technique {technique!r}")
        return ErasureCodeTorch(technique)


def __erasure_code_init__(name: str, directory: str | None) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginTorch())

"""ErasureCode base class: shared padding and decode plumbing.

Re-expresses reference src/erasure-code/ErasureCode.{h,cc}.  The important
contracts preserved:

* SIMD_ALIGN padding — here ALIGN=64 host-side; the CUDA kernels take
  any chunk size and mask the ragged tail.
* encode_prepare (reference ErasureCode.cc:151-186): pad the object with
  zeros to k*chunk_size and slice into k equal data chunks.
* default minimum_to_decode (reference :103-137): if everything wanted is
  available use it, else any k available chunks, full range each.
* decode (reference :212): a dense (k+m, chunk_size) array with zeros
  in the holes, handed to the codec's decode_chunks.
* chunk remapping via the `mapping=` profile key (reference :274).
"""

from __future__ import annotations

import errno

import numpy as np

from .interface import ErasureCodeError, ErasureCodeInterface, Profile

SIMD_ALIGN = 64  # reference uses 32 (ErasureCode.cc:42); 64 also serves cachelines


class ErasureCode(ErasureCodeInterface):
    k: int = 0
    m: int = 0
    # Locality codes (LRC/SHEC) can decode from fewer than k chunks when
    # the right ones are present; they relax the availability precheck.
    ALLOW_PARTIAL_DECODE = False

    def __init__(self) -> None:
        self.chunk_mapping: list[int] = []
        self.profile: Profile | None = None

    # -- init plumbing ------------------------------------------------------

    def init(self, profile: Profile) -> None:
        self.profile = profile
        mapping = profile.get("mapping")
        if mapping:
            self.parse_chunk_mapping(mapping)

    def parse_chunk_mapping(self, mapping: str) -> None:
        """Parse a 'DDD_D...' style remap string: position p of the string
        holds chunk c in order of D occurrences (reference
        ErasureCode.cc:274 chunk_index/chunk_mapping)."""
        n = self.get_chunk_count()
        positions = [i for i, ch in enumerate(mapping) if ch == "D"]
        if len(positions) != n:
            raise ErasureCodeError(
                errno.EINVAL,
                f"mapping {mapping!r} has {len(positions)} D's, need {n}")
        self.chunk_mapping = positions

    # -- geometry -----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_chunk_size(self, stripe_width: int) -> int:
        alignment = self.get_alignment()
        per = (stripe_width + self.k - 1) // self.k
        return -(-per // alignment) * alignment

    def get_alignment(self) -> int:
        return SIMD_ALIGN

    def get_chunk_mapping(self) -> list[int]:
        return list(self.chunk_mapping)

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if self.chunk_mapping else i

    # -- default decode planning -------------------------------------------

    def _minimum_to_decode_ids(self, want_to_read: set[int],
                               available: set[int]) -> set[int]:
        if want_to_read <= available:
            return set(want_to_read)
        if len(available) < self.k:
            raise ErasureCodeError(
                errno.EIO,
                f"want {sorted(want_to_read)} but only "
                f"{sorted(available)} available (k={self.k})")
        return set(sorted(available)[: self.k])

    def minimum_to_decode(self, want_to_read, available):
        """{chunk: [(sub-chunk offset, count)]} to read for `want_to_read`
        (reference ErasureCodeInterface.h:297)."""
        ids = self._minimum_to_decode_ids(set(want_to_read), set(available))
        sub = self.get_sub_chunk_count()
        return {i: [(0, sub)] for i in ids}

    def minimum_to_decode_with_cost(self, want_to_read, available):
        # Default ignores cost (reference ErasureCode.cc:139-149).
        return set(self.minimum_to_decode(set(want_to_read), set(available)))

    # -- encode plumbing ----------------------------------------------------

    def encode_prepare(self, data) -> np.ndarray:
        """Pad to k*chunk_size and slice to a (k, chunk_size) array
        (reference ErasureCode.cc:151-186)."""
        buf = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data.astype(np.uint8, copy=False).ravel()
        chunk_size = self.get_chunk_size(buf.size)
        padded = np.zeros(self.k * chunk_size, dtype=np.uint8)
        padded[: buf.size] = buf
        return padded.reshape(self.k, chunk_size)

    def encode(self, want_to_encode, data):
        chunks = self.encode_prepare(data)
        parity = self.encode_chunks(chunks)
        allc = np.concatenate([chunks, parity], axis=0)
        return {i: allc[i] for i in want_to_encode}

    # -- decode plumbing ----------------------------------------------------

    def _decode_prepare(self, chunks: dict[int, np.ndarray],
                        chunk_size: int) -> tuple[np.ndarray, list[int]]:
        """Assemble a dense (k+m, chunk_size) array with zeros in the holes
        and return (array, erasure list) (reference ErasureCode.cc:212)."""
        n = self.get_chunk_count()
        dense = np.zeros((n, chunk_size), dtype=np.uint8)
        erasures = []
        for i in range(n):
            if i in chunks:
                c = np.asarray(chunks[i], dtype=np.uint8).ravel()
                if c.size != chunk_size:
                    raise ErasureCodeError(
                        errno.EINVAL,
                        f"chunk {i} size {c.size} != {chunk_size}")
                dense[i] = c
            else:
                erasures.append(i)
        return dense, erasures

    def decode(self, want_to_read, chunks, chunk_size):
        dense, erasures = self._decode_prepare(chunks, chunk_size)
        if not erasures or not (set(want_to_read) - set(chunks)):
            return {i: dense[i] for i in want_to_read}
        if not self.ALLOW_PARTIAL_DECODE and \
                self.get_chunk_count() - len(erasures) < self.k:
            raise ErasureCodeError(
                errno.EIO, f"cannot decode: {len(erasures)} erasures > m={self.m}")
        decoded = self.decode_chunks(dense, erasures)
        return {i: decoded[i] for i in want_to_read}

    def decode_chunks(self, dense: np.ndarray,
                      erasures: list[int]) -> np.ndarray:
        """Reconstruct erased rows of the dense (k+m, chunk_size) array.
        Subclasses implement. (reference ErasureCodeInterface.h:411)"""
        raise NotImplementedError

    # -- CRUSH --------------------------------------------------------------

    def create_rule(self, name: str, crush) -> int:
        """Build an `indep` CRUSH rule choosing k+m independent devices
        (reference ErasureCode.cc:64-83) on a map with the reference's
        add_simple_rule."""
        failure_domain = (self.profile.get("crush-failure-domain", "host")
                          if self.profile else "host")
        root = (self.profile.get("crush-root", "default")
                if self.profile else "default")
        return crush.add_simple_rule(
            name, root, failure_domain, num_rep=self.get_chunk_count(),
            rule_mode="indep")

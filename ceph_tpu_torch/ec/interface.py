"""Erasure-code codec contract.

Re-expresses the reference's `ErasureCodeInterface` (reference:
src/erasure-code/ErasureCodeInterface.h:170-462) for this framework.
Semantics kept exactly; types made idiomatic (numpy uint8 buffers instead
of bufferlist, dict/set instead of std::map/std::set, exceptions carrying
errno instead of negative returns).

All codecs are systematic: chunks 0..k-1 carry the
object's data, chunks k..k+m-1 carry parity.  An object is padded out to
k * get_chunk_size(len) before encoding (reference diagram,
ErasureCodeInterface.h:39-78).
"""

from __future__ import annotations

import abc
import errno
from dataclasses import dataclass, field


class ErasureCodeError(Exception):
    """Codec error carrying an errno, mirroring negative-int returns."""

    def __init__(self, err: int, msg: str):
        super().__init__(f"[errno {err} {errno.errorcode.get(err, '?')}] {msg}")
        self.errno = err


@dataclass
class Profile:
    """An EC profile: free-form key=value settings validated by the plugin.

    Mirrors the reference's ErasureCodeProfile (map<string,string>); the
    monitor's `normalize_profile` (src/mon/OSDMonitor.cc:7190) instantiates
    the plugin to validate and fill defaults.
    """

    data: dict[str, str] = field(default_factory=dict)

    def __getitem__(self, k: str) -> str:
        return self.data[k]

    def get(self, k: str, default: str | None = None) -> str | None:
        return self.data.get(k, default)

    def __contains__(self, k: str) -> bool:
        return k in self.data

    def to_int(self, key: str, default: int) -> int:
        """Parse an int profile value; mirrors ErasureCode::to_int
        (reference src/erasure-code/ErasureCode.cc:295) including the
        behavior that an empty/absent value takes the default and a bad
        value raises EINVAL."""
        v = self.data.get(key)
        if v is None or v == "":
            self.data[key] = str(default)
            return default
        try:
            return int(v)
        except ValueError:
            raise ErasureCodeError(
                errno.EINVAL, f"could not convert {key}={v!r} to int")


class ErasureCodeInterface(abc.ABC):
    """Abstract codec (reference ErasureCodeInterface.h:170).

    Chunk buffers are numpy uint8 arrays (or anything memoryview-able);
    implementations may require SIMD-friendly alignment, which
    get_chunk_size() guarantees.
    """

    @abc.abstractmethod
    def init(self, profile: Profile) -> None:
        """Initialize from a profile, filling defaults into it.
        Raises ErasureCodeError(EINVAL) on bad parameters.
        (reference :212)"""

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m. (reference :240)"""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k. (reference :249)"""

    def get_coding_chunk_count(self) -> int:
        """m. (reference :257)"""
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """Sub-chunks per chunk; >1 only for regenerating codes (CLAY).
        (reference :266)"""
        return 1

    @abc.abstractmethod
    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunk size for an object of `stripe_width` bytes: ceil(w/k)
        rounded up so implementation alignment holds.  All chunks of a
        stripe have the same size. (reference :281)"""

    @abc.abstractmethod
    def encode(self, want_to_encode: set[int], data: bytes | memoryview,
               ) -> dict[int, "np.ndarray"]:
        """Pad + split `data` into k data chunks, compute m parity chunks,
        return the subset listed in want_to_encode. (reference :365)"""

    @abc.abstractmethod
    def encode_chunks(self, chunks: "np.ndarray") -> "np.ndarray":
        """Low-level: given (k, chunk_size) data chunk array, return the
        (m, chunk_size) parity chunks. (reference :370)"""

    @abc.abstractmethod
    def decode(self, want_to_read: set[int],
               chunks: dict[int, "np.ndarray"], chunk_size: int,
               ) -> dict[int, "np.ndarray"]:
        """Reconstruct the wanted chunks from the available ones.
        (reference :407)"""

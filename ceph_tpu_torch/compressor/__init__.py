"""Compressor subsystem: pluggable codecs + registry.

Re-expresses reference src/compressor/ (Compressor.h create/registry,
plugin classes for zlib/snappy/lz4/zstd/brotli): a small uniform
compress/decompress contract behind a factory.  This image bakes in
Python's zlib/bz2/lzma, which map onto the reference's zlib/bzip2/
(zstd-role) plugins; snappy/lz4 have no local library and register as
unavailable (the registry reports what it can actually build, like the
reference's plugin load errors).

Consumers: the messenger's on-wire frame compression (reference msgr2.1
compression feature) and any host-side caller.  A TPU kernel family for
decompression is a natural future target (the byte-plane infrastructure
from the EC kernels applies); the subsystem seam is codec-shaped so a
device-backed plugin drops in.
"""

from __future__ import annotations

import bz2
import lzma
import zlib


class CompressorError(Exception):
    pass


# Decompression output cap: peer-supplied compressed frames must not
# amplify into unbounded allocations (a ~1MB lzma bomb expands to tens
# of GB).  Frames larger than this are a protocol violation.
MAX_DECOMPRESSED = 1 << 30


class Compressor:
    """One codec (reference Compressor.h interface)."""

    name = "none"

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, data: bytes,
                   max_out: int = MAX_DECOMPRESSED) -> bytes:
        """Bounded streaming decompression shared by all codecs: ask
        the decompressor for at most max_out+1 bytes; producing more
        than max_out is rejected without materializing the bomb."""
        d = self._decompressor()
        try:
            out = d.decompress(data, max_out + 1)
        except Exception as e:  # noqa: BLE001 - codec-specific errors
            raise CompressorError(str(e)) from e
        if len(out) > max_out:
            raise CompressorError(
                f"decompressed output exceeds cap {max_out}")
        # a stream that did not finish (truncated input) or left
        # trailing bytes must fail loudly, not return partial data
        if not d.eof:
            raise CompressorError("truncated compressed stream")
        if d.unused_data:
            raise CompressorError("trailing garbage after stream")
        return out

    def _decompressor(self):
        raise NotImplementedError


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 1):
        self.level = level   # wire compression favors speed

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def _decompressor(self):
        return zlib.decompressobj()


class Bz2Compressor(Compressor):
    name = "bz2"

    def compress(self, data: bytes) -> bytes:
        return bz2.compress(data, 1)

    def _decompressor(self):
        return bz2.BZ2Decompressor()


class LzmaCompressor(Compressor):
    name = "lzma"

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=0)

    def _decompressor(self):
        return lzma.LZMADecompressor()


_FACTORY = {
    "zlib": ZlibCompressor,
    "bz2": Bz2Compressor,
    "lzma": LzmaCompressor,
}
# roles the reference ships that this image cannot build (no library):
# the registry names them so callers get ENOENT-style clarity, matching
# the reference's plugin load failure surface
_UNAVAILABLE = {"snappy": "no snappy library in this image",
                "lz4": "no lz4 library in this image",
                "zstd": "no zstd library in this image"}


def create(name: str) -> Compressor:
    """Factory (reference Compressor::create)."""
    if name in _FACTORY:
        return _FACTORY[name]()
    if name in _UNAVAILABLE:
        raise CompressorError(
            f"compressor {name!r} unavailable: {_UNAVAILABLE[name]}")
    raise CompressorError(f"unknown compressor {name!r}")


def available() -> list[str]:
    return sorted(_FACTORY)

"""Stable integer hash for CRUSH draws.

Fills the role of the reference's rjenkins1 crush_hash32_* family
(src/crush/hash.c): a deterministic, platform-independent, well-mixed
hash of small integer tuples, stable forever (placement must never
change across versions).  We use our own construction (splitmix64-style
finalizers over packed operands) rather than porting rjenkins bit-for-
bit: this framework's clusters need internal stability, not placement
compatibility with foreign Ceph clusters.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1
_SEED = 0x9E3779B97F4A7C15  # golden-ratio seed, fixed forever


def _mix64(x: int) -> int:
    x &= _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x


def crush_hash32(*args) -> int:
    """Hash ints and/or byte-strings to 32 bits, order-sensitive.

    Fills crush_hash32_*'s role for placement draws and ceph_str_hash's
    (src/common/ceph_hash.cc) for object-name -> pg seed hashing.
    """
    h = _SEED
    for a in args:
        if isinstance(a, str):
            a = a.encode()
        if isinstance(a, (bytes, bytearray)):
            for i in range(0, len(a), 8):
                h = _mix64(h ^ int.from_bytes(a[i:i + 8], "little"))
            h = _mix64(h ^ len(a))
        else:
            h = _mix64(h ^ ((a & _MASK64) + 0x9E3779B97F4A7C15
                            + ((h << 6) & _MASK64) + (h >> 2)))
    return h & _MASK32


def crush_unit_interval(*args: int) -> float:
    """Map a draw to (0, 1]; never returns 0 (ln must be finite)."""
    h = crush_hash32(*args)
    return (h + 1) / 4294967296.0

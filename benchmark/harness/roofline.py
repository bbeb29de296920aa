"""The least time a call's problem can take on a card, from the
problem's shapes alone.

Bytes count every input byte read once, every output byte written once
and one byte a coefficient of the generator or repair matrix; byte
operations count one GF(2^8) multiply-add a (output row, input row,
byte) and one crc step a shard byte.  Whatever kernel computes the
problem, the count is the same, so the share of the least time stays
comparable when a later change replaces a kernel.  A table of lookups
that one implementation stages (the 256-entry product tables) is not
counted: it belongs to that implementation.
"""

from __future__ import annotations

# NVIDIA's data sheet, SXM part: HBM3 bandwidth and the dense int8 rate
# (byte operations), both at the full 700 W
PEAKS = {
    "H100": {"bytes_per_s": 3.35e12, "byte_ops_per_s": 1.979e15},
}


def peak(kind: str) -> dict | None:
    for key, val in PEAKS.items():
        if key in kind:
            return val
    return None


def encode_cost(k: int, m: int, objects: int, shard: int) -> tuple[int, int]:
    """Parity and every shard's crc32c of `objects` objects of k shards
    of `shard` bytes: (bytes, byte operations)."""
    nbytes = objects * ((k + m) * shard + (k + m) * 4) + m * k
    ops = objects * shard * (m * k + (k + m))
    return nbytes, ops


def apply_cost(rows_out: int, rows_in: int, width: int) -> tuple[int, int]:
    """A GF(2^8) matrix apply, (rows_out x rows_in) over `width` bytes a
    row: the repair of a shard from k survivors, or CLAY's repair from
    its helpers' plane rows."""
    nbytes = (rows_in + rows_out) * width + rows_out * rows_in
    return nbytes, rows_out * rows_in * width


def least_seconds(kind: str, nbytes: int, ops: int) -> float | None:
    p = peak(kind)
    if p is None:
        return None
    return max(nbytes / p["bytes_per_s"], ops / p["byte_ops_per_s"])

"""Omap payload framing for client<->OSD op payloads.

The reference encodes omap kv maps with ceph::encode into the op's
bufferlist (osd/osd_types wire maps consumed by the OMAP cases of
PrimaryLogPG::do_osd_ops, PrimaryLogPG.cc:5643).  Here the equivalent
is a minimal length-prefixed binary form shared by librados and the
OSD: u32 count, then per entry u32 klen + key [+ u32 vlen + value].
"""

from __future__ import annotations

import struct

_U32 = struct.Struct("<I")


def encode_kv(kv: dict[bytes, bytes]) -> bytes:
    out = [_U32.pack(len(kv))]
    for k, v in kv.items():
        out.append(_U32.pack(len(k)))
        out.append(k)
        out.append(_U32.pack(len(v)))
        out.append(v)
    return b"".join(out)


def _take(buf: bytes, off: int, ln: int) -> tuple[bytes, int]:
    """Bounds-checked slice: a hostile/corrupt length must raise a
    clean ValueError (mapped to -EINVAL at the op switch), never a
    struct.error past the end or a silent truncation."""
    if ln < 0 or off + ln > len(buf):
        raise ValueError(
            f"omap frame truncated: need {ln} bytes at {off}, "
            f"have {len(buf)}")
    return bytes(buf[off:off + ln]), off + ln


def _u32(buf: bytes, off: int) -> tuple[int, int]:
    if off + 4 > len(buf):
        raise ValueError(f"omap frame truncated at {off}")
    return _U32.unpack_from(buf, off)[0], off + 4


def decode_kv(buf: bytes, off: int = 0) -> tuple[dict[bytes, bytes], int]:
    n, off = _u32(buf, off)
    kv: dict[bytes, bytes] = {}
    for _ in range(n):
        kl, off = _u32(buf, off)
        k, off = _take(buf, off, kl)
        vl, off = _u32(buf, off)
        kv[k], off = _take(buf, off, vl)
    return kv, off


def encode_keys(keys) -> bytes:
    keys = list(keys)
    out = [_U32.pack(len(keys))]
    for k in keys:
        out.append(_U32.pack(len(k)))
        out.append(bytes(k))
    return b"".join(out)


def decode_keys(buf: bytes, off: int = 0) -> tuple[list[bytes], int]:
    n, off = _u32(buf, off)
    keys: list[bytes] = []
    for _ in range(n):
        kl, off = _u32(buf, off)
        k, off = _take(buf, off, kl)
        keys.append(k)
    return keys, off

"""RBD incremental transport: export-diff / import-diff.

Re-expresses the reference's between-snap delta stream
(src/tools/rbd/action/Export.cc export-diff, Import.cc import-diff,
src/librbd/DeepCopyRequest.h role) over this framework's
rados-selfmanaged-snapshot images.

Stream format (own framing, documented here — the reference's v1/v2
banner format is byte-specific to its librbd types):

    magic line   b"ceph-tpu rbd diff v1\\n"
    'm' u32 len  JSON meta {image, from_snap, to_snap, size}
    'w' u64 off u64 len <len bytes>     changed data run
    'z' u64 off u64 len                 run that became zero
    'e'                                 end

Runs are sub-block tight: a changed block contributes only the
[first-diff, last-diff] byte span.  The walk is object-map-assisted on
the head: blocks the map knows were never written are skipped without
an OSD round-trip (they cannot differ — no discard op exists to
remove data that a snapshot still holds).

Deviation vs reference: change detection reads both snap contexts and
compares bytes (the reference consults the OSD's per-object snapset
clone intervals).  At this substrate's scale the read-compare is the
honest equivalent; the stream format is what matters for the backup
workflow.
"""

from __future__ import annotations

import errno
import json
import struct

from ..rados.client import RadosError

MAGIC = b"ceph-tpu rbd diff v1\n"
_U64x2 = struct.Struct("<QQ")


def _emit_span(fh, off: int, old: bytes, new: bytes) -> bool:
    """Write one 'w'/'z' record covering the differing span of a
    block pair; returns True if anything was emitted."""
    if old == new:
        return False
    lo = 0
    hi = max(len(old), len(new))
    o = old.ljust(hi, b"\0")
    n = new.ljust(hi, b"\0")
    while lo < hi and o[lo] == n[lo]:
        lo += 1
    while hi > lo and o[hi - 1] == n[hi - 1]:
        hi -= 1
    span = n[lo:hi]
    if span.count(0) == len(span):
        fh.write(b"z" + _U64x2.pack(off + lo, hi - lo))
    else:
        fh.write(b"w" + _U64x2.pack(off + lo, hi - lo))
        fh.write(span)
    return True


def export_diff(img, fh, from_snap: str | None = None,
                to_snap: str | None = None) -> int:
    """Write the delta stream between from_snap (None = empty image:
    a full export in diff clothing) and to_snap (None = head).
    Returns the number of records emitted."""
    hdr = img._header
    for s in (from_snap, to_snap):
        if s is not None and s not in hdr["snap_ids"]:
            raise RadosError(errno.ENOENT, f"no snap {s}")
    snap_sizes = hdr.get("snap_sizes", {})
    to_size = snap_sizes.get(to_snap, img.size()) if to_snap \
        else img.size()
    from_size = snap_sizes.get(from_snap, img.size()) if from_snap \
        else 0
    from_id = hdr["snap_ids"][from_snap] if from_snap else None
    to_id = hdr["snap_ids"][to_snap] if to_snap else 0
    fh.write(MAGIC)
    meta = json.dumps({"image": img.name, "from_snap": from_snap,
                       "to_snap": to_snap, "size": to_size}).encode()
    fh.write(b"m" + struct.pack("<I", len(meta)) + meta)
    bs = img.block_size
    # the diff's domain is [0, to_size): the import resizes the target
    # first, so content beyond to_size needs no records — emitting any
    # would make import write past the (shrunk) end
    nblocks = -(-to_size // bs)
    omap = img._live_omap()
    records = 0
    for b in range(nblocks):
        window = max(0, min(bs, to_size - b * bs))
        if window == 0:
            continue
        if from_id is None and omap is not None and \
                not omap.object_may_exist(b):
            # full-export mode (baseline = zeros): a block absent at
            # head reads zeros == baseline, nothing to emit.  The
            # skip is NOT sound for snap-to-snap diffs — a shrink +
            # regrow leaves the head block absent while the from-snap
            # clone still holds data (resize is a discard).
            continue
        new = img._read_block_at(b, to_id)[:window]
        if from_id is None:
            old = b"\0" * len(new)
        else:
            old = img._read_block_at(b, from_id)[:window]
        if _emit_span(fh, b * bs, old, new):
            records += 1
    fh.write(b"e")
    return records


def _read_exact(fh, n: int) -> bytes:
    buf = fh.read(n)
    if len(buf) != n:
        raise RadosError(errno.EINVAL, "truncated diff stream")
    return buf


def import_diff(img, fh) -> dict:
    """Apply a delta stream onto an image.  The image must already
    carry the stream's from_snap (same name — the reference checks
    the end-snap of the previous diff the same way); the stream's
    to_snap is created at the end, so chained diffs compose."""
    if _read_exact(fh, len(MAGIC)) != MAGIC:
        raise RadosError(errno.EINVAL, "not a ceph-tpu rbd diff stream")
    tag = _read_exact(fh, 1)
    if tag != b"m":
        raise RadosError(errno.EINVAL, f"expected meta, got {tag!r}")
    (mlen,) = struct.unpack("<I", _read_exact(fh, 4))
    meta = json.loads(_read_exact(fh, mlen).decode())
    from_snap = meta.get("from_snap")
    if from_snap is not None and \
            from_snap not in img._header["snap_ids"]:
        raise RadosError(
            errno.EINVAL,
            f"image {img.name} lacks base snap {from_snap!r} — "
            f"this diff does not apply here")
    if meta["size"] != img.size():
        img.resize(meta["size"])
    applied = {"w": 0, "z": 0, "bytes": 0}
    while True:
        tag = _read_exact(fh, 1)
        if tag == b"e":
            break
        if tag not in (b"w", b"z"):
            raise RadosError(errno.EINVAL, f"bad record tag {tag!r}")
        off, ln = _U64x2.unpack(_read_exact(fh, _U64x2.size))
        if tag == b"w":
            data = _read_exact(fh, ln)
            img.write(off, data)
            applied["w"] += 1
            applied["bytes"] += ln
        else:
            img.write(off, b"\0" * ln)
            applied["z"] += 1
    to_snap = meta.get("to_snap")
    if to_snap and to_snap not in img._header["snap_ids"]:
        img.snap_create(to_snap)
    return applied

"""Typed messages + wire envelope.

Re-expresses the reference's Message model (src/msg/Message.h; 163 typed
headers in src/messages/) and ProtocolV2's crc-protected framing
(src/msg/async/ProtocolV2.cc:728 frame assembly, frames_v2.h): every
message travels as

  magic(4) | type(u16) | seq(u64) | meta_len(u32) | data_len(u64)
  | header_crc(u32) || meta(json) || data(raw) || payload_crc(u32)

meta is a small JSON control dict (the reference's encoded header
fields); data is the raw byte segment (bufferlist payload) so the data
plane never round-trips through JSON.  Both are covered by crc32c like
ProtocolV2's crc mode.  (Secure/AES-GCM mode is a hook, not implemented;
auth layer gates connections instead.)

Messages self-describe via a type registry keyed by `type_id`, the
analog of decode_message()'s switch over CEPH_MSG_* constants.
"""

from __future__ import annotations

import json
import struct

from ..common import crc32c as _crc

MAGIC = b"CTPU"
_HEADER = struct.Struct("<4sHxxQIQI")  # magic, type, seq, meta_len, data_len, hcrc

# Control frames handled by the messenger itself, below the typed-message
# registry (the analog of ProtocolV2's HELLO/ACK tag frames,
# reference src/msg/async/frames_v2.h Tag::HELLO / Tag::ACK).
CTRL_HELLO = 0xFFF0   # session open/resume: meta = {entity, in_seq, lossless}
CTRL_ACK = 0xFFF1     # seq field = highest contiguously-received seq
CTRL_ENC = 0xFFF2     # secure mode: data = 12-byte nonce + AESGCM(frame)
CTRL_COMP = 0xFFF3    # compressed: meta={"a": algo}, data = comp(frame)

_REGISTRY: dict[int, type["Message"]] = {}


def encode_frame(tid: int, seq: int, meta: dict, data: bytes = b"") -> bytes:
    """Assemble one crc-protected wire frame (shared by typed messages
    and the messenger's control frames)."""
    meta_raw = json.dumps(meta, separators=(",", ":")).encode()
    head = _HEADER.pack(MAGIC, tid, seq, len(meta_raw), len(data), 0)
    hcrc = _crc.crc32c(head[:-4], 0xFFFFFFFF)
    head = head[:-4] + struct.pack("<I", hcrc)
    pcrc = _crc.crc32c(data, _crc.crc32c(meta_raw, 0xFFFFFFFF))
    return head + meta_raw + data + struct.pack("<I", pcrc)


def register_message(cls: type["Message"]) -> type["Message"]:
    tid = cls.type_id
    assert tid not in _REGISTRY, f"duplicate message type {tid}"
    _REGISTRY[tid] = cls
    return cls


class Message:
    """Base message: subclasses set type_id and implement meta/data."""

    type_id: int = 0

    def __init__(self) -> None:
        self.seq = 0

    # -- subclass surface ---------------------------------------------------

    def to_meta(self) -> dict:
        return {}

    def data_segment(self) -> bytes:
        return b""

    @classmethod
    def from_wire(cls, meta: dict, data: bytes) -> "Message":
        msg = cls.__new__(cls)
        Message.__init__(msg)
        msg.decode_wire(meta, data)
        return msg

    def decode_wire(self, meta: dict, data: bytes) -> None:
        pass

    def data_parts(self) -> list[bytes]:
        """The data segment as a list of buffers.  Payload-heavy
        messages override this so the wire path never concatenates
        their bytes (writev-style framing); data_segment() stays the
        joined view for decode symmetry."""
        d = self.data_segment()
        return [d] if d else []

    # -- envelope -----------------------------------------------------------

    def encode(self, seq: int = 0) -> bytes:
        return encode_frame(self.type_id, seq, self.to_meta(),
                            self.data_segment())

    def encode_parts(self, seq: int = 0) -> tuple[bytes, ...]:
        """Zero-concat frame: (head+meta, *data_parts, pcrc).  Joining
        the parts yields exactly encode(seq) — retention stores the
        tuple and only joins on (rare) replay; the writer writes each
        part, so a 1 MiB payload is never copied into a frame buffer."""
        meta_raw = json.dumps(self.to_meta(),
                              separators=(",", ":")).encode()
        parts = self.data_parts()
        dlen = sum(len(p) for p in parts)
        head = _HEADER.pack(MAGIC, self.type_id, seq, len(meta_raw),
                            dlen, 0)
        hcrc = _crc.crc32c(head[:-4], 0xFFFFFFFF)
        head = head[:-4] + struct.pack("<I", hcrc)
        c = _crc.crc32c(meta_raw, 0xFFFFFFFF)
        for p in parts:
            c = _crc.crc32c(p, c)
        return (head + meta_raw, *parts, struct.pack("<I", c))

    HEADER_SIZE = _HEADER.size

    @staticmethod
    def parse_header(raw: bytes) -> tuple[int, int, int, int]:
        """-> (type_id, seq, meta_len, data_len); raises on corruption."""
        magic, tid, seq, meta_len, data_len, hcrc = _HEADER.unpack(raw)
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        want = _crc.crc32c(raw[:-4], 0xFFFFFFFF)
        if want != hcrc:
            raise ValueError(f"header crc mismatch {want:#x} != {hcrc:#x}")
        return tid, seq, meta_len, data_len

    @staticmethod
    def decode(tid: int, seq: int, meta_raw: bytes, data: bytes,
               pcrc: int) -> "Message":
        want = _crc.crc32c(data, _crc.crc32c(meta_raw, 0xFFFFFFFF))
        if want != pcrc:
            raise ValueError(f"payload crc mismatch {want:#x} != {pcrc:#x}")
        cls = _REGISTRY.get(tid)
        if cls is None:
            raise ValueError(f"unknown message type {tid}")
        msg = cls.from_wire(json.loads(meta_raw.decode()), data)
        msg.seq = seq
        return msg

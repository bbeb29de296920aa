"""The typed message set for the storage protocol.

Re-expresses the slice of the reference's 163 message types
(src/messages/) this framework's daemons speak:

client <-> OSD:   MOSDOp / MOSDOpReply (reference MOSDOp.h)
OSD <-> OSD (EC): MOSDECSubOpWrite / ...WriteReply / ...Read /
                  ...ReadReply (reference MOSDECSubOpWrite.h etc.,
                  carrying ECSubWrite/ECSubRead from ECMsgTypes.h)
OSD <-> OSD:      MOSDPing (heartbeat, reference MOSDPing.h)
daemon <-> mon:   MMonGetMap/MMonMap, MOSDBoot, MOSDFailure,
                  MMonCommand/MMonCommandAck (pool + profile admin)

Wire layout follows message.py: JSON meta for control fields, one raw
data segment for payload bytes (write data / read replies / serialized
shard transactions).
"""

from __future__ import annotations

import json

import numpy as np

from ..osd.types import eversion_t, hobject_t, pg_t, spg_t
from ..store.object_store import Transaction
from ..store import object_store as os_
from .message import Message, register_message


# -- id plumbing -------------------------------------------------------------

def hobj_to_json(o: hobject_t) -> list:
    return [o.pool, o.name, o.key, o.snap, o.hash]


def hobj_from_json(j) -> hobject_t:
    return hobject_t(*j)


def spg_to_json(s: spg_t) -> list:
    return [s.pgid.pool, s.pgid.seed, s.shard]


def spg_from_json(j) -> spg_t:
    return spg_t(pg_t(j[0], j[1]), j[2])


# -- transaction wire form ---------------------------------------------------

def txn_to_wire(txn: Transaction) -> tuple[list, bytes]:
    """Serialize a store Transaction: op records in JSON + one data blob
    (write payloads, xattr/omap values) addressed by (offset, length)."""
    ops = []
    blob = bytearray()

    def put(b: bytes) -> list[int]:
        off = len(blob)
        blob.extend(b)
        return [off, len(b)]

    def g2j(g):
        return [hobj_to_json(g.hobj), g.generation, g.shard]

    for op in txn.ops:
        if isinstance(op, os_.OpTouch):
            ops.append(["touch", g2j(op.oid)])
        elif isinstance(op, os_.OpWrite):
            ops.append(["write", g2j(op.oid), op.offset,
                        put(op.data.tobytes())])
        elif isinstance(op, os_.OpZero):
            ops.append(["zero", g2j(op.oid), op.offset, op.length])
        elif isinstance(op, os_.OpTruncate):
            ops.append(["truncate", g2j(op.oid), op.size])
        elif isinstance(op, os_.OpRemove):
            ops.append(["remove", g2j(op.oid)])
        elif isinstance(op, os_.OpSetAttrs):
            ops.append(["setattrs", g2j(op.oid),
                        {k: put(v) for k, v in op.attrs.items()}])
        elif isinstance(op, os_.OpRmAttr):
            ops.append(["rmattr", g2j(op.oid), op.name])
        elif isinstance(op, os_.OpClone):
            ops.append(["clone", g2j(op.src), g2j(op.dst)])
        elif isinstance(op, os_.OpRename):
            ops.append(["rename", g2j(op.src), g2j(op.dst)])
        elif isinstance(op, os_.OpOmapSet):
            ops.append(["omapset", g2j(op.oid),
                        [[put(k), put(v)] for k, v in op.kv.items()]])
        elif isinstance(op, os_.OpOmapRmKeys):
            ops.append(["omaprm", g2j(op.oid), [put(k) for k in op.keys]])
        elif isinstance(op, os_.OpOmapClear):
            ops.append(["omapclear", g2j(op.oid)])
        elif isinstance(op, os_.OpOmapSetHeader):
            ops.append(["omaphdr", g2j(op.oid), put(op.data)])
        else:
            raise TypeError(f"cannot serialize {op!r}")
    return ops, bytes(blob)


def txn_from_wire(ops: list, blob: bytes) -> Transaction:
    from ..osd.types import ghobject_t

    def get(ref) -> bytes:
        off, ln = ref
        return blob[off:off + ln]

    def j2g(j):
        return ghobject_t(hobj_from_json(j[0]), j[1], j[2])

    t = Transaction()
    for rec in ops:
        kind = rec[0]
        if kind == "touch":
            t.touch(j2g(rec[1]))
        elif kind == "write":
            t.write(j2g(rec[1]), rec[2],
                    np.frombuffer(get(rec[3]), dtype=np.uint8))
        elif kind == "zero":
            t.zero(j2g(rec[1]), rec[2], rec[3])
        elif kind == "truncate":
            t.truncate(j2g(rec[1]), rec[2])
        elif kind == "remove":
            t.remove(j2g(rec[1]))
        elif kind == "setattrs":
            t.setattrs(j2g(rec[1]), {k: get(v) for k, v in rec[2].items()})
        elif kind == "rmattr":
            t.rmattr(j2g(rec[1]), rec[2])
        elif kind == "clone":
            t.clone(j2g(rec[1]), j2g(rec[2]))
        elif kind == "rename":
            t.rename(j2g(rec[1]), j2g(rec[2]))
        elif kind == "omapset":
            t.omap_setkeys(j2g(rec[1]),
                           {get(k): get(v) for k, v in rec[2]})
        elif kind == "omaprm":
            t.omap_rmkeys(j2g(rec[1]), [get(k) for k in rec[2]])
        elif kind == "omapclear":
            t.omap_clear(j2g(rec[1]))
        elif kind == "omaphdr":
            t.omap_setheader(j2g(rec[1]), get(rec[2]))
        else:
            raise ValueError(f"unknown wire op {kind}")
    return t


# -- client ops --------------------------------------------------------------

@register_message
class MOSDOp(Message):
    """Client -> primary OSD op (reference src/messages/MOSDOp.h).
    ops: list of [opname, offset, length] with write payloads
    concatenated in the data segment in op order."""

    type_id = 42

    def __init__(self, pgid: spg_t, oid: hobject_t, ops: list,
                 data: bytes = b"", tid: int = 0, epoch: int = 0,
                 snapc: list | None = None,
                 trace: dict | None = None,
                 qos: str | None = None):
        super().__init__()
        self.pgid, self.oid, self.ops = pgid, oid, ops
        self.data, self.tid, self.epoch = data, tid, epoch
        # SnapContext [seq, [snap ids]] for self-managed snapshots
        # (reference MOSDOp snap_seq + snaps)
        self.snapc = snapc
        # Dapper-style trace context (common/tracked_op.py
        # TraceContext.to_wire): stitches the client's objecter span
        # to the primary's op span across the wire
        self.trace = trace
        # client-declared QoS class (dmclock rides client info on the
        # op the same way): the mClock scheduler's per-tenant key;
        # None schedules as plain "client"
        self.qos = qos

    def to_meta(self):
        m = {"pgid": spg_to_json(self.pgid),
             "oid": hobj_to_json(self.oid),
             "ops": self.ops, "tid": self.tid, "epoch": self.epoch,
             "snapc": self.snapc}
        if self.trace is not None:
            m["trace"] = self.trace
        if self.qos is not None:
            m["qos"] = self.qos
        return m

    def data_segment(self):
        return self.data

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.oid = hobj_from_json(meta["oid"])
        self.ops, self.tid = meta["ops"], meta["tid"]
        self.epoch = meta["epoch"]
        self.snapc = meta.get("snapc")
        self.trace = meta.get("trace")
        self.qos = meta.get("qos")
        self.data = data


@register_message
class MOSDOpReply(Message):
    """reference MOSDOpReply.h."""

    type_id = 43

    def __init__(self, tid: int, result: int, data: bytes = b"",
                 epoch: int = 0):
        super().__init__()
        self.tid, self.result, self.data, self.epoch = \
            tid, result, data, epoch

    def to_meta(self):
        return {"tid": self.tid, "result": self.result, "epoch": self.epoch}

    def data_segment(self):
        return self.data

    def decode_wire(self, meta, data):
        self.tid, self.result = meta["tid"], meta["result"]
        self.epoch = meta["epoch"]
        self.data = data


# -- EC sub-ops --------------------------------------------------------------

@register_message
class MOSDECSubOpWrite(Message):
    """Primary -> shard write (reference MOSDECSubOpWrite.h carrying
    ECSubWrite: shard transaction + version + log entries + committed
    bound, ECMsgTypes.h:38 — log_entries ride the sub-write so the data
    and its history land in one shard transaction)."""

    type_id = 108

    def __init__(self, pgid: spg_t, tid: int, at_version: eversion_t,
                 txn: Transaction, log_entries: list | None = None,
                 rollforward_to: eversion_t | None = None,
                 trace: dict | None = None):
        super().__init__()
        self.pgid, self.tid, self.at_version, self.txn = \
            pgid, tid, at_version, txn
        self.log_entries = log_entries or []    # wire lists (entry_to_wire)
        self.rollforward_to = rollforward_to
        # child trace context of the primary's op span (the shard
        # holder registers its sub-op span under the same trace id)
        self.trace = trace

    def to_meta(self):
        ops, blob = txn_to_wire(self.txn)
        self._blob = blob
        rf = self.rollforward_to
        m = {"pgid": spg_to_json(self.pgid), "tid": self.tid,
             "v": [self.at_version.epoch, self.at_version.version],
             "ops": ops, "log": self.log_entries,
             "rf": [rf.epoch, rf.version] if rf is not None else None}
        if self.trace is not None:
            m["trace"] = self.trace
        return m

    def data_segment(self):
        return self._blob

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]
        self.at_version = eversion_t(*meta["v"])
        self.txn = txn_from_wire(meta["ops"], data)
        self.log_entries = meta.get("log", [])
        rf = meta.get("rf")
        self.rollforward_to = eversion_t(*rf) if rf else None
        self.trace = meta.get("trace")


@register_message
class MOSDECSubOpWriteReply(Message):
    type_id = 109

    def __init__(self, pgid: spg_t, tid: int, shard: int, result: int = 0):
        super().__init__()
        self.pgid, self.tid, self.shard, self.result = \
            pgid, tid, shard, result

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid,
                "shard": self.shard, "result": self.result}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid, self.shard = meta["tid"], meta["shard"]
        self.result = meta["result"]


@register_message
class MOSDECSubOpRead(Message):
    """Primary -> shard read (reference MOSDECSubOpRead.h / ECSubRead:
    per-shard extent list + attr wants)."""

    type_id = 110

    def __init__(self, pgid: spg_t, tid: int, oid: hobject_t,
                 off: int, length: int, want_attrs: bool = False,
                 want_omap: bool = False):
        super().__init__()
        self.pgid, self.tid, self.oid = pgid, tid, oid
        self.off, self.length, self.want_attrs = off, length, want_attrs
        self.want_omap = want_omap

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid,
                "oid": hobj_to_json(self.oid), "off": self.off,
                "len": self.length, "attrs": self.want_attrs,
                "omap": self.want_omap}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]
        self.oid = hobj_from_json(meta["oid"])
        self.off, self.length = meta["off"], meta["len"]
        self.want_attrs = meta["attrs"]
        self.want_omap = meta.get("omap", False)


@register_message
class MOSDECSubOpReadReply(Message):
    type_id = 111

    def __init__(self, pgid: spg_t, tid: int, shard: int, result: int,
                 data: bytes = b"", attrs: dict[str, bytes] | None = None,
                 size: int = -1,
                 omap: dict[bytes, bytes] | None = None,
                 omap_header: bytes = b""):
        super().__init__()
        self.pgid, self.tid, self.shard, self.result = \
            pgid, tid, shard, result
        self.data = data
        self.attrs = attrs or {}
        self.size = size  # shard object size; -1 = absent
        # omap rides only when the read asked want_omap (replicated
        # backfill pulls whole-object state across OSDs on PG split)
        self.omap = omap or {}
        self.omap_header = omap_header

    def to_meta(self):
        # attrs (+ optional omap) ride the data segment after the
        # read payload
        blob = {"a": {k: v.hex() for k, v in self.attrs.items()}}
        if self.omap:
            blob["o"] = {k.hex(): v.hex()
                         for k, v in self.omap.items()}
        if self.omap_header:
            blob["oh"] = self.omap_header.hex()
        self._attr_blob = json.dumps(blob).encode()
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid,
                "shard": self.shard, "result": self.result,
                "dlen": len(self.data), "size": self.size}

    def data_segment(self):
        return self.data + self._attr_blob

    def data_parts(self):
        # zero-concat wire path: the (up to 128 KiB+) shard payload is
        # never copied into a joined frame buffer
        return [p for p in (self.data, self._attr_blob) if p]

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid, self.shard = meta["tid"], meta["shard"]
        self.result = meta["result"]
        self.size = meta["size"]
        dlen = meta["dlen"]
        self.data = data[:dlen]
        blob = json.loads(data[dlen:].decode())
        if "a" not in blob:      # pre-omap layout: the blob IS attrs
            blob = {"a": blob}
        self.attrs = {k: bytes.fromhex(v)
                      for k, v in blob["a"].items()}
        self.omap = {bytes.fromhex(k): bytes.fromhex(v)
                     for k, v in blob.get("o", {}).items()}
        self.omap_header = bytes.fromhex(blob.get("oh", ""))


# -- heartbeat / mon ---------------------------------------------------------

@register_message
class MOSDPing(Message):
    """reference MOSDPing.h (PING / PING_REPLY)."""

    type_id = 70

    def __init__(self, from_osd: int, epoch: int = 0, is_reply: bool = False,
                 stamp: float = 0.0):
        super().__init__()
        self.from_osd, self.epoch, self.is_reply, self.stamp = \
            from_osd, epoch, is_reply, stamp

    def to_meta(self):
        return {"from": self.from_osd, "epoch": self.epoch,
                "reply": self.is_reply, "stamp": self.stamp}

    def decode_wire(self, meta, data):
        self.from_osd, self.epoch = meta["from"], meta["epoch"]
        self.is_reply, self.stamp = meta["reply"], meta["stamp"]


@register_message
class MMonGetMap(Message):
    """Map subscription / refresh request.  `have_epoch` is the
    subscriber's current osdmap epoch (reference: the `start` epoch in
    MMonSubscribe's sub_osdmap): 0 means "no map, send a full"; a
    current epoch turns the request into a ~free keepalive ack, and
    anything in the mon's incremental ring gets a delta chain instead
    of the full payload (docs/ARCHITECTURE.md "Map distribution")."""

    type_id = 4

    def __init__(self, what: str = "osdmap", have_epoch: int = 0):
        super().__init__()
        self.what = what
        self.have_epoch = have_epoch

    def to_meta(self):
        return {"what": self.what, "have": self.have_epoch}

    def decode_wire(self, meta, data):
        self.what = meta["what"]
        # absent on messages from an older sender: 0 = full map
        self.have_epoch = meta.get("have", 0)


@register_message
class MMonMap(Message):
    """OSDMap payload (reference MOSDMap.h); JSON-serialized map."""

    type_id = 5

    def __init__(self, map_json: dict | None = None):
        super().__init__()
        self.map_json = map_json or {}

    def to_meta(self):
        return {}

    def data_segment(self):
        return json.dumps(self.map_json).encode()

    def decode_wire(self, meta, data):
        self.map_json = json.loads(data.decode()) if data else {}


@register_message
class MOSDMapInc(Message):
    """Incremental osdmap range (reference MOSDMap carrying
    OSDMap::Incremental epochs): `incs` is a contiguous chain of
    committed epoch deltas (osd_map.Incremental wire JSON, oldest
    first) the subscriber applies on top of its current map; an EMPTY
    chain with `epoch` equal to the subscriber's map is the keepalive
    ack a current daemon's MMonGetMap(have_epoch=) heartbeat earns —
    bytes instead of a full-map serialization.  The mon's central
    config sections ride every send like they do on MMonMap."""

    type_id = 6

    def __init__(self, epoch: int = 0, incs: list | None = None,
                 config: dict | None = None):
        super().__init__()
        self.epoch = epoch          # the epoch the chain ends at
        self.incs = incs or []
        self.config = config or {}

    def to_meta(self):
        return {"epoch": self.epoch}

    def data_segment(self):
        return json.dumps({"incs": self.incs,
                           "config": self.config}).encode()

    def decode_wire(self, meta, data):
        self.epoch = meta["epoch"]
        body = json.loads(data.decode()) if data else {}
        self.incs = body.get("incs", [])
        self.config = body.get("config", {})


@register_message
class MOSDBoot(Message):
    """OSD announces itself up (reference MOSDBoot.h)."""

    type_id = 71

    def __init__(self, osd_id: int = -1, addr: tuple[str, int] | None = None):
        super().__init__()
        self.osd_id, self.addr = osd_id, addr

    def to_meta(self):
        return {"osd": self.osd_id, "addr": list(self.addr or ())}

    def decode_wire(self, meta, data):
        self.osd_id = meta["osd"]
        a = meta["addr"]
        self.addr = (a[0], a[1]) if a else None


@register_message
class MOSDFailure(Message):
    """Failure report to the mon (reference MOSDFailure.h)."""

    type_id = 72

    def __init__(self, reporter: int = -1, failed: int = -1,
                 epoch: int = 0):
        super().__init__()
        self.reporter, self.failed, self.epoch = reporter, failed, epoch

    def to_meta(self):
        return {"reporter": self.reporter, "failed": self.failed,
                "epoch": self.epoch}

    def decode_wire(self, meta, data):
        self.reporter, self.failed = meta["reporter"], meta["failed"]
        self.epoch = meta["epoch"]


@register_message
class MOSDSlowOpReport(Message):
    """OSD -> mon slow-op health report (the role of the reference's
    osd beacon / MMonHealthChecks feeding the SLOW_OPS warning): the
    tracker's slow_op_summary, re-sent while the condition holds and
    once more — with count 0 — to clear it."""

    type_id = 73

    def __init__(self, osd_id: int = -1, report: dict | None = None):
        super().__init__()
        self.osd_id = osd_id
        self.report = report or {}

    def to_meta(self):
        return {"osd": self.osd_id, "report": self.report}

    def decode_wire(self, meta, data):
        self.osd_id = meta["osd"]
        self.report = meta.get("report", {})


@register_message
class MPGStats(Message):
    """OSD -> mon PG-state summary (reference MPGStats via the mgr):
    per-pool degraded/misplaced/unfound object and PG counts plus the
    seeds of PGs with split/merge pushes still pending.  Feeds the
    mon's `pg stat` command, the PG_DEGRADED health check, and the
    split/merge interleave guard on pg_num decreases.  Transient
    leader-side state like slow-op reports: re-sent every stats tick,
    expired by staleness."""

    type_id = 74

    def __init__(self, osd_id: int = -1, report: dict | None = None):
        super().__init__()
        self.osd_id = osd_id
        self.report = report or {}

    def to_meta(self):
        return {"osd": self.osd_id, "report": self.report}

    def decode_wire(self, meta, data):
        self.osd_id = meta["osd"]
        self.report = meta.get("report", {})


@register_message
class MMonCommand(Message):
    """Admin command (reference MMonCommand.h; `ceph` CLI JSON dispatch)."""

    type_id = 50

    def __init__(self, cmd: dict | None = None, tid: int = 0):
        super().__init__()
        self.cmd = cmd or {}
        self.tid = tid

    def to_meta(self):
        return {"cmd": self.cmd, "tid": self.tid}

    def decode_wire(self, meta, data):
        self.cmd, self.tid = meta["cmd"], meta["tid"]


@register_message
class MMonCommandAck(Message):
    type_id = 51

    def __init__(self, tid: int = 0, result: int = 0, out: dict | None = None):
        super().__init__()
        self.tid, self.result, self.out = tid, result, out or {}

    def to_meta(self):
        return {"tid": self.tid, "result": self.result, "out": self.out}

    def decode_wire(self, meta, data):
        self.tid, self.result = meta["tid"], meta["result"]
        self.out = meta["out"]


# -- PG scan / recovery push (reference MOSDPGScan / MOSDPGPush) -------------

@register_message
class MPGList(Message):
    """List objects of a PG shard collection (reference MOSDPGScan role,
    used by backfill and scrub)."""

    type_id = 112

    def __init__(self, pgid: spg_t = None, tid: int = 0):
        super().__init__()
        self.pgid, self.tid = pgid, tid

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]


@register_message
class MPGListReply(Message):
    type_id = 113

    def __init__(self, pgid: spg_t = None, tid: int = 0,
                 oids: list | None = None):
        super().__init__()
        self.pgid, self.tid = pgid, tid
        self.oids = oids or []   # list of hobject json lists

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid,
                "oids": self.oids}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]
        self.oids = meta["oids"]


# -- cephfs (reference MClientRequest.h / MClientReply.h) --------------------

@register_message
class MClientRequest(Message):
    """FS client -> MDS metadata op (reference MClientRequest: op code
    + filepath + args; here op is a verb string and args a JSON dict)."""

    type_id = 24

    def __init__(self, op: str = "", args: dict | None = None,
                 tid: int = 0):
        super().__init__()
        self.op, self.args, self.tid = op, args or {}, tid

    def to_meta(self):
        return {"op": self.op, "args": self.args, "tid": self.tid}

    def decode_wire(self, meta, data):
        self.op, self.args, self.tid = \
            meta["op"], meta["args"], meta["tid"]


@register_message
class MClientCaps(Message):
    """MDS -> client capability message (reference MClientCaps:
    grant/revoke of file caps).  caps is a string subset of "rwc"
    (read / write / cache-and-buffer)."""

    type_id = 26

    def __init__(self, op: str = "", ino: int = 0, caps: str = "",
                 seq: int = 0):
        super().__init__()
        self.op, self.ino, self.caps, self.seq = op, ino, caps, seq

    def to_meta(self):
        return {"op": self.op, "ino": self.ino, "caps": self.caps,
                "seq": self.seq}

    def decode_wire(self, meta, data):
        self.op, self.ino, self.caps, self.seq = \
            meta["op"], meta["ino"], meta["caps"], meta["seq"]


@register_message
class MClientReply(Message):
    type_id = 25

    def __init__(self, tid: int = 0, result: int = 0,
                 out: dict | None = None):
        super().__init__()
        self.tid, self.result, self.out = tid, result, out or {}

    def to_meta(self):
        return {"tid": self.tid, "result": self.result, "out": self.out}

    def decode_wire(self, meta, data):
        self.tid, self.result, self.out = \
            meta["tid"], meta["result"], meta["out"]


# -- auth (reference MAuth.h / MAuthReply.h, cephx ticket exchange) ----------

@register_message
class MAuth(Message):
    """Client -> mon: issue me a service ticket (reference MAuth
    carrying CephXRequest; the connection itself was already
    authenticated with the client's own key)."""

    type_id = 63

    def __init__(self, entity: str = "", tid: int = 0):
        super().__init__()
        self.entity, self.tid = entity, tid

    def to_meta(self):
        return {"entity": self.entity, "tid": self.tid}

    def decode_wire(self, meta, data):
        self.entity, self.tid = meta["entity"], meta["tid"]


@register_message
class MAuthReply(Message):
    """Mon -> client: sealed ticket + session key (session key sealed
    under the CLIENT's key so only it can read it — reference
    CephXTicketBlob + encrypted session key)."""

    type_id = 64

    def __init__(self, tid: int = 0, result: int = 0,
                 ticket: str = "", sealed_key: str = ""):
        super().__init__()
        self.tid, self.result = tid, result
        self.ticket, self.sealed_key = ticket, sealed_key

    def to_meta(self):
        return {"tid": self.tid, "result": self.result,
                "ticket": self.ticket, "sealed_key": self.sealed_key}

    def decode_wire(self, meta, data):
        self.tid, self.result = meta["tid"], meta["result"]
        self.ticket, self.sealed_key = meta["ticket"], meta["sealed_key"]


# -- mon quorum (reference MMonElection.h / MMonPaxos.h) ---------------------

@register_message
class MMonPaxos(Message):
    """Mon <-> mon consensus traffic: election (propose/ack/victory)
    and paxos (collect/last/begin/accept/commit/lease) share one frame
    (the reference splits MMonElection and MMonPaxos; the field union
    is small enough to carry in one typed message here)."""

    type_id = 60

    def __init__(self, op: str = "", rank: int = -1, epoch: int = 0,
                 pn: int = 0, value: dict | None = None,
                 quorum: list | None = None,
                 committed: dict | None = None,
                 uncommitted: list | None = None):
        super().__init__()
        self.op, self.rank, self.epoch, self.pn = op, rank, epoch, pn
        self.value, self.quorum = value, quorum
        self.committed, self.uncommitted = committed, uncommitted

    def to_meta(self):
        return {"op": self.op, "rank": self.rank, "epoch": self.epoch,
                "pn": self.pn, "value": self.value,
                "quorum": self.quorum, "committed": self.committed,
                "uncommitted": self.uncommitted}

    def decode_wire(self, meta, data):
        self.op, self.rank = meta["op"], meta["rank"]
        self.epoch, self.pn = meta["epoch"], meta["pn"]
        self.value, self.quorum = meta["value"], meta["quorum"]
        self.committed = meta["committed"]
        self.uncommitted = meta["uncommitted"]


# -- peering (reference MOSDPGLog.h / MOSDPGInfo.h / PeeringState GetLog) ----

@register_message
class MPGLogQuery(Message):
    """New primary -> shard: send me your pg_info + log (reference
    PeeringState GetInfo/GetLog phases, pg_query_t)."""

    type_id = 116

    def __init__(self, pgid: spg_t = None, tid: int = 0):
        super().__init__()
        self.pgid, self.tid = pgid, tid

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]


@register_message
class MPGLogReply(Message):
    """Shard -> querying primary: pg_info + full log entries (reference
    MOSDPGLog carrying pg_log_t)."""

    type_id = 117

    def __init__(self, pgid: spg_t = None, tid: int = 0,
                 info: dict | None = None, entries: list | None = None):
        super().__init__()
        self.pgid, self.tid = pgid, tid
        self.info = info or {}          # pg_info_t.to_json()
        self.entries = entries or []    # entry_to_wire lists

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid,
                "info": self.info, "entries": self.entries}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]
        self.info, self.entries = meta["info"], meta["entries"]


@register_message
class MPGLogRollback(Message):
    """Primary -> divergent shard: roll your log back to `v` using local
    rollback state (the reference expresses this as the divergent-entry
    branch of PGLog::merge_log + ECBackend rollback transactions)."""

    type_id = 118

    def __init__(self, pgid: spg_t = None, tid: int = 0,
                 v: eversion_t = None):
        super().__init__()
        self.pgid, self.tid, self.v = pgid, tid, v

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid,
                "v": [self.v.epoch, self.v.version]}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]
        self.v = eversion_t(*meta["v"])


@register_message
class MPGLogRollbackReply(Message):
    type_id = 119

    def __init__(self, pgid: spg_t = None, tid: int = 0,
                 removed: list | None = None):
        super().__init__()
        self.pgid, self.tid = pgid, tid
        self.removed = removed or []    # hobj json lists needing recovery

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid,
                "removed": self.removed}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]
        self.removed = meta["removed"]


@register_message
class MPGActivate(Message):
    """Primary -> shard: the interval is peered; persist
    last_epoch_started (and, for a stale shard, adopt the authoritative
    log).  Reference MOSDPGLog activation + PeeringState::activate."""

    type_id = 121

    def __init__(self, pgid: spg_t = None, tid: int = 0, les: int = 0,
                 head: eversion_t = None, entries: list | None = None,
                 adopt: bool = False):
        super().__init__()
        self.pgid, self.tid, self.les = pgid, tid, les
        self.head = head or eversion_t()
        self.entries = entries or []
        self.adopt = adopt

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid,
                "les": self.les, "head": [self.head.epoch,
                                          self.head.version],
                "entries": self.entries, "adopt": self.adopt}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid, self.les = meta["tid"], meta["les"]
        self.head = eversion_t(*meta["head"])
        self.entries = meta["entries"]
        self.adopt = meta["adopt"]


@register_message
class MPGActivateReply(Message):
    type_id = 122

    def __init__(self, pgid: spg_t = None, tid: int = 0):
        super().__init__()
        self.pgid, self.tid = pgid, tid

    def to_meta(self):
        return {"pgid": spg_to_json(self.pgid), "tid": self.tid}

    def decode_wire(self, meta, data):
        self.pgid = spg_from_json(meta["pgid"])
        self.tid = meta["tid"]


# -- watch / notify (reference MWatchNotify.h, osd/Watch.h) ------------------

@register_message
class MWatchNotify(Message):
    """OSD -> watcher delivery AND watcher ack (dir field), plus the
    client->OSD watch/unwatch/notify control ops ride MOSDOp; this
    message carries the out-of-band notify fan-out."""

    type_id = 120

    def __init__(self, oid: hobject_t = None, notify_id: int = 0,
                 cookie: int = 0, payload: bytes = b"",
                 is_ack: bool = False):
        super().__init__()
        self.oid, self.notify_id, self.cookie = oid, notify_id, cookie
        self.payload, self.is_ack = payload, is_ack

    def to_meta(self):
        return {"oid": hobj_to_json(self.oid), "nid": self.notify_id,
                "cookie": self.cookie, "ack": self.is_ack}

    def data_segment(self):
        return self.payload

    def decode_wire(self, meta, data):
        self.oid = hobj_from_json(meta["oid"])
        self.notify_id, self.cookie = meta["nid"], meta["cookie"]
        self.is_ack = meta["ack"]
        self.payload = data

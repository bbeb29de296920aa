"""The messenger of the port against the JAX package's: every registered
message type encodes to the same frame bytes in both packages and
decodes across them, a port messenger and a reference messenger talk
on loopback in both directions, and the cases of tests/test_messenger.py
that need no wire kill replay on the port."""

import struct
import time

import numpy as np
import pytest

import ceph_tpu.msg as jmsg
import ceph_tpu.msg.message as jmessage
import ceph_tpu.msg.messages as jM
import ceph_tpu.osd.types as jtypes
import ceph_tpu.store.object_store as jos
import ceph_tpu_torch.msg as tmsg
import ceph_tpu_torch.msg.message as tmessage
import ceph_tpu_torch.msg.messages as tM
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.store.object_store as tos
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

PORT = dict(M=tM, T=ttypes, os=tos)
REF = dict(M=jM, T=jtypes, os=jos)


def _txn(p, rng):
    T, os_ = p["T"], p["os"]
    g = T.ghobject_t(T.hobject_t(2, "obj", "k", -2, 77), 5, 1)
    h = T.ghobject_t(T.hobject_t(2, "dst"), shard=1)
    t = os_.Transaction()
    t.touch(g)
    t.write(g, 100, rng.integers(0, 256, 300, dtype=np.uint8))
    t.zero(g, 10, 20)
    t.setattrs(g, {"hinfo_key": b"\x01\x02", "_": b""})
    t.rmattr(g, "old")
    t.omap_setkeys(g, {b"k": b"v", b"k2": b"\x00" * 9})
    t.omap_rmkeys(g, [b"gone"])
    t.omap_setheader(g, b"hdr")
    t.omap_clear(h)
    t.clone(g, h)
    t.rename(h, g)
    t.truncate(g, 50)
    t.remove(g)
    return t


def samples(p):
    """One instance of every registered message type, its fields set
    to something other than their defaults, built from the same seed in
    either package."""
    M, T = p["M"], p["T"]
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    pg = T.spg_t(T.pg_t(3, 5), 2)
    oid = T.hobject_t(3, "rbd_data.1", "", -2, 1234)
    v = T.eversion_t(7, 42)
    log = [[7, 42, [3, "rbd_data.1", "", -2, 1234], 1, 100, 25, True,
            "0a0b", None]]
    trace = {"t": "ab" * 8, "s": "cd" * 4, "p": None}
    out = [
        M.MMonGetMap("osdmap", have_epoch=9),
        M.MMonMap({"epoch": 3, "pools": []}),
        M.MOSDMapInc(epoch=4, incs=[{"epoch": 4, "prev": 3}],
                     config={"osd": {"a": "1"}}),
        M.MClientRequest("open", {"path": "/a"}, tid=3),
        M.MClientReply(tid=3, result=-2, out={"x": [1, 2]}),
        M.MClientCaps("grant", ino=5, caps="rw", seq=2),
        M.MOSDOp(pg, oid, [["write", 0, len(payload)], ["stat"]],
                 payload, tid=11, epoch=6, snapc=[4, [4, 2]],
                 trace=trace, qos="client"),
        M.MOSDOpReply(11, -5, payload[:100], epoch=6),
        M.MMonCommand({"prefix": "osd pool ls"}, tid=2),
        M.MMonCommandAck(tid=2, result=0, out={"pools": ["a"]}),
        M.MMonPaxos("begin", rank=1, epoch=3, pn=101, value={"v": 1},
                    quorum=[0, 1, 2], committed={"c": 2},
                    uncommitted=[100, {"u": 3}]),
        M.MAuth("client.admin", tid=4),
        M.MAuthReply(tid=4, result=0, ticket="t1", sealed_key="s1"),
        M.MOSDPing(from_osd=3, epoch=9, is_reply=True, stamp=1.5),
        M.MOSDBoot(4, ("127.0.0.1", 7004)),
        M.MOSDFailure(reporter=1, failed=2, epoch=8),
        M.MOSDSlowOpReport(osd_id=1, report={"ops": 3}),
        M.MPGStats(osd_id=2, report={"pools": {"1": {"objects": 4}}}),
        M.MOSDECSubOpWrite(pg, 42, v, _txn(p, rng), log_entries=log,
                           rollforward_to=T.eversion_t(7, 40),
                           trace=trace),
        M.MOSDECSubOpWriteReply(pg, 42, 2, result=-5),
        M.MOSDECSubOpRead(pg, 43, oid, 4096, 8192, want_attrs=True,
                          want_omap=True),
        M.MOSDECSubOpReadReply(pg, 43, 2, 0, payload,
                               attrs={"hinfo_key": b"\x09" * 12},
                               size=8192, omap={b"a": b"b"},
                               omap_header=b"h"),
        M.MPGList(pg, tid=5),
        M.MPGListReply(pg, tid=5, oids=[[3, "a", "", -2, 1]]),
        M.MPGLogQuery(pg, tid=6),
        M.MPGLogReply(pg, tid=6, info={"lu": [7, 42], "les": 3},
                      entries=log),
        M.MPGLogRollback(pg, tid=7, v=v),
        M.MPGLogRollbackReply(pg, tid=7, removed=[[3, "a"]]),
        M.MWatchNotify(oid, notify_id=8, cookie=9, payload=b"ping",
                       is_ack=True),
        M.MPGActivate(pg, tid=10, les=3, head=v, entries=log, adopt=True),
        M.MPGActivateReply(pg, tid=10),
    ]
    return out


def _split(raw: bytes):
    tid, seq, mlen, dlen = jmessage.Message.parse_header(
        raw[:jmessage.Message.HEADER_SIZE])
    h = jmessage.Message.HEADER_SIZE
    (pcrc,) = struct.unpack("<I", raw[-4:])
    return tid, seq, raw[h:h + mlen], raw[h + mlen:h + mlen + dlen], pcrc


def test_every_registered_type_has_a_sample():
    assert sorted(tmessage._REGISTRY) == sorted(jmessage._REGISTRY)
    for reg, p in ((tmessage._REGISTRY, PORT), (jmessage._REGISTRY, REF)):
        assert sorted(type(m).type_id for m in samples(p)) == sorted(reg)


@pytest.mark.parametrize("i", range(31))
def test_message_encodes_alike_and_decodes_across(i):
    t_msg, j_msg = samples(PORT)[i], samples(REF)[i]
    assert type(t_msg).__name__ == type(j_msg).__name__
    t_raw, j_raw = t_msg.encode(seq=i + 1), j_msg.encode(seq=i + 1)
    assert t_raw == j_raw
    assert b"".join(t_msg.encode_parts(seq=i + 1)) == t_raw
    # each package decodes the other's frame as it decodes its own
    # (a decode may drop a field the type does not carry on the wire:
    # re-encoding shows what each side read)
    j_from_t = jmessage.Message.decode(*_split(t_raw))
    t_from_j = tmessage.Message.decode(*_split(j_raw))
    t_own = tmessage.Message.decode(*_split(t_raw))
    assert type(j_from_t).__name__ == type(t_from_j).__name__ == \
        type(t_msg).__name__
    assert j_from_t.encode(seq=i + 1) == t_from_j.encode(seq=i + 1) == \
        t_own.encode(seq=i + 1)


def _pair(server_pkg, client_pkg, n=20):
    """A server messenger of one package answering pings, a client of
    the other sending n pings and an OSD op; (got, replies)."""
    got, replies = [], []
    server = server_pkg.Messenger("server")
    SM = server_pkg.messages

    def on_msg(conn, msg):
        got.append(msg)
        if isinstance(msg, SM.MOSDPing):
            conn.send_message(SM.MOSDPing(msg.from_osd, is_reply=True))
    server.add_dispatcher(on_msg)
    addr = server.bind(("127.0.0.1", 0))
    client = client_pkg.Messenger("client")
    client.add_dispatcher(lambda conn, msg: replies.append(msg))
    CM = client_pkg.messages
    T = ttypes if client_pkg is tmsg else jtypes
    try:
        conn = client.connect(addr)
        for i in range(n):
            conn.send_message(CM.MOSDPing(from_osd=i, epoch=i))
        payload = bytes(np.random.default_rng(3).integers(
            0, 256, 1 << 20, dtype=np.uint8))
        conn.send_message(CM.MOSDOp(T.spg_t(T.pg_t(1, 1), 0),
                                    T.hobject_t(1, "big"),
                                    [["write", 0, len(payload)]], payload))
        deadline = time.time() + 15
        while (len(got) < n + 1 or len(replies) < n) and \
                time.time() < deadline:
            time.sleep(0.01)
        return got, replies, payload
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.parametrize("server,client", [("port", "ref"),
                                           ("ref", "port")])
def test_messengers_talk_across_packages(server, client):
    pkg = {"port": tmsg, "ref": jmsg}
    got, replies, payload = _pair(pkg[server], pkg[client])
    assert [m.from_osd for m in got[:20]] == list(range(20))
    assert bytes(got[20].data) == payload
    assert len(replies) == 20 and all(r.is_reply for r in replies)


MESSENGER = ported("test_messenger")


@pytest.mark.parametrize("case", [
    "test_envelope_roundtrip", "test_envelope_corruption_detected",
    "test_payload_crc_detected", "test_transaction_wire_roundtrip",
    "test_ec_subop_write_roundtrip", "test_client_server_exchange",
    "test_large_payload"])
def test_messenger_replay(case):
    run_case(MESSENGER, case)

"""The PG log of the port (ceph_tpu_torch/osd/pg_log.py) against the JAX
package's: the backend-level peering scenarios of tests/test_peering.py
(log persistence on every shard, the wire round trip, shard-local
rollback of a pure append and of an overwrite) replayed on both sides,
and each peering / split / merge method of PGLog and ShardPGLog (trim,
rollback_to, set_les, adopt, split_out, merge_split, fold_in) applied
to the same log on both sides: the entries, the info, the persisted
omap and a reload from the store must be equal."""

import numpy as np
import pytest

import ceph_tpu.ec as jec
import ceph_tpu.osd.ec_backend as jbe
import ceph_tpu.osd.ec_transaction as ject
import ceph_tpu.osd.ec_util as jutil
import ceph_tpu.osd.pg_log as jlog
import ceph_tpu.osd.types as jtypes
import ceph_tpu.store as jstore
import ceph_tpu_torch.ec as tec
import ceph_tpu_torch.osd.ec_backend as tbe
import ceph_tpu_torch.osd.ec_transaction as tect
import ceph_tpu_torch.osd.ec_util as tutil
import ceph_tpu_torch.osd.pg_log as tlog
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.store as tstore


class Side:
    def __init__(self, port: bool, k=2, m=1, chunk=64):
        self.port = port
        (self.ec, self.be, self.ect, self.util, self.log, self.types,
         self.store_mod) = \
            (tec, tbe, tect, tutil, tlog, ttypes, tstore) if port \
            else (jec, jbe, ject, jutil, jlog, jtypes, jstore)
        codec = self.ec.ErasureCodePluginRegistry.instance().factory(
            "jerasure", {"k": str(k), "m": str(m)})
        self.store = self.store_mod.MemStore()
        self.store.mount()
        self.shards = self.be.LocalShardBackend(
            self.store, self.types.pg_t(1, 0), k + m)
        kw = {"device": "cpu"} if port else {}
        self.backend = self.be.ECBackend(
            codec, self.util.StripeInfo(k * chunk, chunk), self.shards, **kw)

    def oid(self, name):
        return self.types.hobject_t(pool=1, name=name)

    def cid(self, s):
        return self.types.spg_t(self.types.pg_t(1, 0), s)

    def put(self, name, payload, version, offset=0):
        txn = self.ect.PGTransaction()
        txn.write(self.oid(name), offset, payload)
        done = []
        self.backend.submit_transaction(
            txn, self.types.eversion_t(1, version), lambda: done.append(1))
        assert done

    def slog(self, s):
        return self.shards.shard_logs[s]

    def state(self, s):
        """A shard log's entries (wire form), info and persisted omap,
        and the same after a reload from the store."""
        slog = self.slog(s)
        re = self.log.ShardPGLog(self.store, self.cid(s), s)
        moid = slog.moid
        omap = self.store.omap_get(self.cid(s), moid)
        return {"entries": [self.log.entry_to_wire(e)
                            for e in slog.log.entries],
                "info": slog.info.to_json(),
                "head": str(slog.log.head), "tail": str(slog.log.tail),
                "omap": sorted(omap.items()),
                "reloaded": [self.log.entry_to_wire(e)
                             for e in re.log.entries],
                "reloaded_info": re.info.to_json()}

    def shard_bytes(self, s, name):
        goid = self.ect.shard_oid(self.oid(name), s)
        return (self.store.read(self.cid(s), goid).tobytes(),
                self.store.getattr(self.cid(s), goid, "hinfo_key"))


def sub_writes_persist_log(side):
    rng = np.random.default_rng(0)
    side.put("a", rng.integers(0, 256, 256, dtype=np.uint8), 1)
    side.put("b", rng.integers(0, 256, 300, dtype=np.uint8), 2)
    out = []
    for s in range(side.backend.n):
        slog = side.slog(s)
        assert slog.info.last_update == side.types.eversion_t(1, 2)
        assert [e.oid.name for e in slog.log.entries] == ["a", "b"]
        for e in slog.log.entries:
            assert e.rollback.pure_append
            assert e.rollback.old_chunk_size == 0
        st = side.state(s)
        assert st["reloaded"] == st["entries"]
        out.append(st)
    return out


def log_entry_wire_roundtrip(side):
    rng = np.random.default_rng(1)
    side.put("x", rng.integers(0, 256, 200, dtype=np.uint8), 1)
    side.put("x", rng.integers(0, 256, 100, dtype=np.uint8), 2)
    out = []
    for e in side.backend.log.entries:
        w = side.log.entry_to_wire(e)
        e2 = side.log.entry_from_wire(w)
        assert e2.version == e.version and e2.oid == e.oid
        assert e2.op == e.op
        assert e2.rollback.pure_append == e.rollback.pure_append
        assert e2.rollback.old_chunk_size == e.rollback.old_chunk_size
        assert e2.rollback.hinfo_old == e.rollback.hinfo_old
        out.append(w)
    return out


def rollback_pure_append(side):
    rng = np.random.default_rng(2)
    side.put("v", rng.integers(0, 256, 256, dtype=np.uint8), 1)
    before = side.shard_bytes(0, "v")
    side.put("v", rng.integers(0, 256, 128, dtype=np.uint8), 2, offset=256)
    assert side.shard_bytes(0, "v") != before
    removed = side.slog(0).rollback_to(side.types.eversion_t(1, 1))
    assert removed == []
    assert side.shard_bytes(0, "v") == before
    assert side.slog(0).info.last_update == side.types.eversion_t(1, 1)
    assert [e.version.version for e in side.slog(0).log.entries] == [1]
    return side.state(0), side.shard_bytes(0, "v")


def rollback_overwrite_via_generation(side):
    rng = np.random.default_rng(3)
    side.put("w", rng.integers(0, 256, 256, dtype=np.uint8), 1)
    before = side.shard_bytes(1, "w")[0]
    side.put("w", rng.integers(0, 256, 64, dtype=np.uint8), 2)
    entry = side.slog(1).log.entries[-1]
    assert not entry.rollback.pure_append
    assert entry.rollback.kept_generation == 2
    assert side.slog(1).rollback_to(side.types.eversion_t(1, 1)) == []
    assert side.shard_bytes(1, "w")[0] == before
    return side.state(1), side.shard_bytes(1, "w")


SCENARIOS = {f.__name__: f for f in (
    sub_writes_persist_log, log_entry_wire_roundtrip, rollback_pure_append,
    rollback_overwrite_via_generation)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_peering_scenario_matches_reference(scenario):
    assert SCENARIOS[scenario](Side(True)) == SCENARIOS[scenario](Side(False))


def _written(side, n=6):
    rng = np.random.default_rng(10)
    for v in range(1, n + 1):
        side.put(f"o{v % 3}", rng.integers(0, 256, 128, dtype=np.uint8), v,
                 offset=128 * (v // 3))
    return side


def _ev(side, v):
    return side.types.eversion_t(1, v)


def _rollback_fresh_log(side):
    """PGLog.rollback_to on a log holding shard 0's entries, not yet
    rolled forward."""
    log = side.log.PGLog()
    for e in side.slog(0).log.entries:
        log.add(e)
    undone = log.rollback_to(_ev(side, 4))
    return ([side.log.entry_to_wire(e) for e in undone], str(log.head),
            [str(e.version) for e in log.entries])


METHODS = {
    "pglog_trim": lambda s: (s.backend.log.trim(_ev(s, 3)),
                             [str(e.version) for e in s.backend.log.entries],
                             str(s.backend.log.tail)),
    "pglog_rollback_to": lambda s: _rollback_fresh_log(s),
    "set_les": lambda s: (s.slog(0).set_les(7), s.slog(0).set_les(3),
                          s.state(0)),
    "adopt": lambda s: (s.slog(2).adopt(s.slog(0).log.entries[:4],
                                        _ev(s, 4), 5), s.state(2)),
    "split_out": lambda s: (
        [s.log.entry_to_wire(e) for e in s.slog(1).split_out({"o1"})],
        s.slog(1).split_out({"absent"}), s.state(1)),
    "merge_split": lambda s: (
        s.slog(0).merge_split(
            s.slog(0).split_out({"o2"})[:1]
            + [s.log.LogEntry(_ev(s, 9), s.oid("new"))],
            _ev(s, 9), 4), s.state(0)),
    "fold_in": lambda s: (
        s.slog(1).fold_in(s.slog(1).split_out({"o0"})
                          + [s.log.LogEntry(_ev(s, 99), s.oid("late"))]),
        s.state(1)),
}


@pytest.mark.parametrize("method", list(METHODS))
def test_log_method_matches_reference(method):
    port = METHODS[method](_written(Side(True)))
    ref = METHODS[method](_written(Side(False)))
    assert port == ref

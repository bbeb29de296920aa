"""The OSD-local foundations of the port against the JAX package's: the
object store's zero / append / omap ops, headers, collections and
commit callbacks (store/object_store.py, store/mem_store.py); the PG
transaction's omap ops and PreparedWrite (osd/ec_transaction.py);
PoolType, with_hash and no_gen (osd/types.py);
ExtentCache.clear_object; SnapSet (osd/snapset.py); and the replicated
backend (osd/replicated_backend.py).  Each case runs the same seeded
sequence through both packages and compares what comes out."""

import numpy as np
import pytest

import ceph_tpu.osd.ec_transaction as ject
import ceph_tpu.osd.extent_cache as jcache
import ceph_tpu.osd.pg_log as jlog
import ceph_tpu.osd.replicated_backend as jrep
import ceph_tpu.osd.snapset as jsnap
import ceph_tpu.osd.types as jtypes
import ceph_tpu.store as jstore
import ceph_tpu.store.object_store as jos
import ceph_tpu_torch.osd.ec_transaction as tect
import ceph_tpu_torch.osd.extent_cache as tcache
import ceph_tpu_torch.osd.pg_log as tlog
import ceph_tpu_torch.osd.replicated_backend as trep
import ceph_tpu_torch.osd.snapset as tsnap
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.store as tstore
import ceph_tpu_torch.store.object_store as tos

PORT = dict(ect=tect, cache=tcache, log=tlog, rep=trep, snap=tsnap,
            types=ttypes, store=tstore, os=tos)
REF = dict(ect=ject, cache=jcache, log=jlog, rep=jrep, snap=jsnap,
           types=jtypes, store=jstore, os=jos)


def both(fn):
    """fn(modules) on the port and on the reference; both results."""
    return fn(PORT), fn(REF)


def _store_state(m, store, cid, goid):
    try:
        data = bytes(store.read(cid, goid))
    except KeyError:
        data = None
    try:
        omap = sorted(store.omap_get(cid, goid).items())
        header = store.omap_get_header(cid, goid)
        attrs = sorted(store.getattrs(cid, goid).items())
    except KeyError:
        omap = header = attrs = None
    return data, omap, header, attrs


def store_ops(m):
    t = m["types"]
    store = m["store"].MemStore()
    store.mount()
    cid = t.spg_t(t.pg_t(3, 1), 0)
    goid = t.ghobject_t(t.hobject_t(pool=3, name="obj"), shard=0)
    events = [store.collection_exists(cid)]
    store.create_collection(cid)
    events.append(store.collection_exists(cid))
    rng = np.random.default_rng(4)
    a = m["os"].Transaction()
    events.append(a.empty())
    a.write(goid, 0, rng.integers(0, 256, 300, dtype=np.uint8))
    a.zero(goid, 10, 20)
    a.zero(goid, 290, 40)                     # zero past the end extends
    a.omap_setkeys(goid, {b"a": b"1", b"b": b"2", b"c": b"3"})
    a.omap_setheader(goid, b"hdr")
    a.register_on_commit(lambda: events.append("a"))
    b = m["os"].Transaction()
    b.omap_rmkeys(goid, [b"b", b"zz"])
    b.setattrs(goid, {"x": b"1"})
    b.register_on_commit(lambda: events.append("b"))
    a.append(b)
    events.append((a.empty(), len(a.ops), len(a.on_commit)))
    store.queue_transactions(cid, [a])
    events.append(_store_state(m, store, cid, goid))
    c = m["os"].Transaction()
    c.omap_clear(goid)
    c.omap_setkeys(goid, {b"d": b"4"})
    c.register_on_commit(lambda: events.append("c"))
    store.queue_transactions(cid, [c])
    events.append(_store_state(m, store, cid, goid))
    other = t.ghobject_t(t.hobject_t(pool=3, name="none"), shard=0)
    events.append(store.omap_get_header(cid, goid))
    try:
        store.omap_get_header(cid, other)
        events.append("no KeyError")
    except KeyError:
        events.append("KeyError")
    store.remove_collection(cid)
    events.append(store.collection_exists(cid))
    store.remove_collection(cid)              # absent: no error
    store.umount()
    return events


def pg_transaction_omap(m):
    t = m["types"]
    o = t.hobject_t(pool=1, name="o")
    txn = m["ect"].PGTransaction()
    txn.write(o, 0, np.arange(8, dtype=np.uint8))
    txn.omap_setkeys(o, {b"k": b"v"})
    txn.omap_rmkeys(o, (b"k",))
    txn.omap_setheader(o, bytearray(b"h"))
    txn.omap_clear(o)
    before = list(txn.obj(o).omap_ops)
    txn.delete(o)
    txn.omap_setkeys(o, {b"after": b"1"})
    pw = m["ect"].PreparedWrite(o, m["ect"].Extent(0, 64),
                                np.zeros((3, 32), dtype=np.uint8))
    return (before, txn.obj(o).omap_ops, txn.obj(o).delete,
            (repr(pw.oid), pw.extent.off, pw.extent.length, pw.shards.shape))


def types_helpers(m):
    t = m["types"]
    o = t.hobject_t(pool=2, name="x", hash=5)
    g = t.ghobject_t(o, generation=7, shard=1)
    return ([(p.name, int(p)) for p in t.PoolType],
            repr(o.with_hash(0x1_2345_6789)), o.with_hash(9) == o,
            repr(g.no_gen()), g.no_gen().generation == t.NO_GEN)


def extent_cache_clear(m):
    t = m["types"]
    cache = m["cache"].ExtentCache()
    a, b = t.hobject_t(name="a"), t.hobject_t(name="b")
    cache.present(a, 0, np.arange(16, dtype=np.uint8))
    cache.present(b, 8, np.ones(8, dtype=np.uint8))
    n0 = len(cache)
    cache.clear_object(a)
    cache.clear_object(t.hobject_t(name="absent"))
    buf = np.zeros(16, dtype=np.uint8)
    hit_a = cache.overlay(a, 0, buf.copy())
    hit_b = cache.overlay(b, 0, buf.copy())
    return n0, len(cache), [bytes(np.asarray(x)) if x is not None else None
                            for x in (hit_a, hit_b)]


def snapset_ops(m):
    rng = np.random.default_rng(12)
    ss = m["snap"].SnapSet(born=int(rng.integers(0, 3)))
    out = []
    for _ in range(30):
        seq = int(rng.integers(0, 40))
        out.append(ss.needs_cow(seq))
        if ss.needs_cow(seq):
            ss.add_clone(seq)
        out.append([ss.resolve(s) for s in range(0, 45, 3)])
    raw = ss.encode()
    back = m["snap"].SnapSet.decode(raw)
    out.append((raw, back.seq, back.clones, back.born, back.prior_born,
                m["snap"].SnapSet.decode(None).clones, m["snap"].SNAPDIR,
                m["snap"].SS_KEY))
    return out


def replicated_backend(m):
    t = m["types"]
    store = m["store"].MemStore()
    store.mount()
    reps = m["rep"].LocalReplicaBackend(store, t.pg_t(1, 2), 3)
    be = m["rep"].ReplicatedBackend(reps)
    rng = np.random.default_rng(6)
    o = t.hobject_t(pool=1, name="r")
    acks = []
    for v in range(1, 5):
        txn = m["ect"].PGTransaction()
        txn.write(o, 16 * v, rng.integers(0, 256, 40, dtype=np.uint8))
        txn.setattr(o, "a", bytes([v]))
        if v == 2:
            txn.setattr(o, "a", None)
            txn.omap_setkeys(o, {b"x": b"1", b"y": b"2"})
            txn.omap_setheader(o, b"H")
        if v == 3:
            txn.omap_rmkeys(o, [b"x"])
            txn.truncate(o, 50)
        if v == 4:
            txn.delete(o)
            txn.write(o, 0, np.full(5, 7, dtype=np.uint8))
            txn.omap_clear(o)
        be.submit_transaction(txn, t.eversion_t(1, v),
                              lambda v=v: acks.append(v))
    state = [_store_state(m, store, reps.cids[r],
                          t.ghobject_t(o, shard=t.NO_SHARD))
             for r in range(3)]
    return (acks, be.completed, bytes(be.read(o)), be.stat(o),
            be.stat(t.hobject_t(pool=1, name="nope")), state,
            [(str(e.version), e.op.name) for e in be.log.entries],
            str(be.log.rollforward_to))


CASES = {f.__name__: f for f in (store_ops, pg_transaction_omap,
                                 types_helpers, extent_cache_clear,
                                 snapset_ops, replicated_backend)}


@pytest.mark.parametrize("case", list(CASES))
def test_foundation_matches_reference(case):
    port, ref = both(CASES[case])
    assert port == ref


def test_replicas_hold_the_same_bytes():
    _, _, data, size, _, state, _, _ = replicated_backend(PORT)
    assert size == len(data) == 5
    assert state[0] == state[1] == state[2]
    assert state[0][1] == [] and state[0][2] == b""


def test_store_create_waits_for_the_persistent_stores():
    """create_store names FileStore and BlueStore, which the port has
    not yet: it builds a MemStore, raises for the persistent kinds
    (naming them as not ported), and the store package keeps the
    reference's other names."""
    assert isinstance(tstore.create_store("memstore"), tstore.MemStore)
    for kind in ("filestore", "bluestore", "bluestore-zlib"):
        with pytest.raises(NotImplementedError, match="not ported"):
            tstore.create_store(kind, "/nonexistent")
    with pytest.raises(ValueError, match="unknown objectstore"):
        tstore.create_store("nostore")
    for name in ("ObjectStore", "Transaction", "MemStore"):
        assert getattr(tstore, name) is not None

"""The slice as a whole: the same transactions through ceph_tpu's
ECBackend (plugin jax, CPU) and the port's (plugin torch,
device="cpu"), on a MemStore each.  Every shard's bytes, xattrs
(HashInfo included) and omap (the shard PG log) must be equal in the
two stores, and every read equal.  Scenarios mirror
tests/test_ec_pipeline.py."""

import dataclasses

import numpy as np
import pytest

import ceph_tpu.ec as jec
import ceph_tpu.osd.ec_backend as jbe
import ceph_tpu.osd.ec_transaction as ject
import ceph_tpu.osd.ec_util as jutil
import ceph_tpu.osd.types as jtypes
import ceph_tpu.store as jstore
import ceph_tpu_torch.ec as tec
import ceph_tpu_torch.osd.ec_backend as tbe
import ceph_tpu_torch.osd.ec_transaction as tect
import ceph_tpu_torch.osd.ec_util as tutil
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.store as tstore
from ceph_tpu_torch.common import crc32c as tcrc


def _degradable(base):
    class Shards(base):
        down: set

        def sub_read(self, shard, oid, off, length, on_done):
            if shard in self.down:
                on_done(shard, None)
                return
            super().sub_read(shard, oid, off, length, on_done)
    return Shards


class Side:
    """One package's backend + store."""

    def __init__(self, pkg, k, m, chunk):
        ec, be, self.ect, util, self.types, store = pkg
        if ec is jec:
            codec = ec.ErasureCodePluginRegistry.instance().factory(
                "jax", {"k": str(k), "m": str(m)})
        else:
            codec = ec.ErasureCodePluginRegistry.instance().factory(
                "torch", {"k": str(k), "m": str(m), "device": "cpu"})
        self.store = store.MemStore()
        self.store.mount()
        self.shards = _degradable(be.LocalShardBackend)(
            self.store, self.types.pg_t(1, 0), k + m)
        self.shards.down = set()
        self.backend = be.ECBackend(
            codec, util.StripeInfo(stripe_width=k * chunk, chunk_size=chunk),
            self.shards)
        self.acks = []

    def oid(self, name):
        return self.types.hobject_t(pool=1, name=name)

    def submit(self, ops, version):
        txn = self.ect.PGTransaction()
        for kind, name, *args in ops:
            o = self.oid(name)
            if kind == "write":
                txn.write(o, args[0], args[1])
            elif kind == "truncate":
                txn.truncate(o, args[0])
            elif kind == "delete":
                txn.delete(o)
            elif kind == "setattr":
                txn.setattr(o, args[0], args[1])
        self.backend.submit_transaction(
            txn, self.types.eversion_t(1, version),
            lambda v=version: self.acks.append(v))

    def dump(self):
        out = {}
        for cid in self.store.list_collections():
            for goid in self.store.list_objects(cid):
                key = (dataclasses.astuple(cid), dataclasses.astuple(goid))
                out[key] = (self.store.read(cid, goid).tobytes(),
                            self.store.getattrs(cid, goid),
                            self.store.omap_get(cid, goid))
        return out


JAX = (jec, jbe, ject, jutil, jtypes, jstore)
TORCH = (tec, tbe, tect, tutil, ttypes, tstore)


class Twin:
    def __init__(self, k=4, m=2, chunk=64):
        self.j = Side(JAX, k, m, chunk)
        self.t = Side(TORCH, k, m, chunk)
        self.version = 0

    def submit(self, *ops):
        self.version += 1
        for side in (self.j, self.t):
            side.submit(ops, self.version)

    def both(self, fn):
        return fn(self.j), fn(self.t)

    def check_stores(self):
        dj, dt = self.j.dump(), self.t.dump()
        assert dj.keys() == dt.keys()
        for key in dj:
            assert dj[key] == dt[key], key
        assert self.j.acks == self.t.acks

    def check_read(self, name, off=0, length=None, down=()):
        for side in (self.j, self.t):
            side.shards.down = set(down)
        try:
            rj = self.j.backend.read(self.j.oid(name), off, length)
            rt = self.t.backend.read(self.t.oid(name), off, length)
        finally:
            for side in (self.j, self.t):
                side.shards.down = set()
        np.testing.assert_array_equal(rt, rj)
        return rt


def _payload(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def test_write_read_roundtrip():                  # test_ec_pipeline:103
    tw = Twin()
    p = _payload(0, 1000)
    tw.submit(("write", "obj1", 0, p))
    np.testing.assert_array_equal(tw.check_read("obj1", 0, 1000), p)
    tw.check_stores()


def test_rmw_partial_overwrite():                 # test_ec_pipeline:115
    tw = Twin()
    base = (np.arange(512) % 251).astype(np.uint8)
    tw.submit(("write", "obj2", 0, base))
    patch = np.full(30, 0xAB, dtype=np.uint8)
    tw.submit(("write", "obj2", 300, patch))
    expect = base.copy()
    expect[300:330] = patch
    np.testing.assert_array_equal(tw.check_read("obj2", 0, 512), expect)
    tw.check_stores()


def test_unaligned_read():                        # test_ec_pipeline:132
    tw = Twin()
    p = ((np.arange(700) * 7) % 256).astype(np.uint8)
    tw.submit(("write", "obj3", 0, p))
    np.testing.assert_array_equal(tw.check_read("obj3", 123, 400),
                                  p[123:523])
    tw.check_stores()


def test_batch_of_mixed_sizes_coalesces():        # test_ec_pipeline:143
    tw = Twin()
    sizes = [256, 5000, 64, 256 * 40, 1000, 256]
    with tw.j.backend.batch(), tw.t.backend.batch():
        for i, n in enumerate(sizes):
            tw.submit(("write", f"b{i}", 0, _payload(10 + i, n)))
    for side in (tw.j, tw.t):
        assert side.backend.completed == len(sizes)
        assert side.backend.batched_extents == len(sizes)
        assert side.backend.batched_launches == 1
    for i, n in enumerate(sizes):
        np.testing.assert_array_equal(tw.check_read(f"b{i}"),
                                      _payload(10 + i, n))
    tw.check_stores()


def test_hinfo_crc_written_and_valid():           # test_ec_pipeline:181
    tw = Twin()
    p = np.arange(512, dtype=np.uint8)
    tw.submit(("write", "obj5", 0, p))
    tw.check_stores()
    be = tw.t.backend
    hinfo = be.shards.get_hinfo(0, tw.t.oid("obj5"))
    assert hinfo.total_chunk_size == 128 and hinfo.crc_valid
    shards = tutil.encode(be.sinfo, be.ec_impl, p)
    for s in range(6):
        assert hinfo.get_chunk_hash(s) == tcrc.crc32c(shards[s].tobytes())


def test_pipeline_window_acks_in_submit_order():  # test_ec_pipeline:394
    tw = Twin()
    payloads = [_payload(30 + i, 512) for i in range(5)]
    seen = 0
    with tw.j.backend.pipeline(), tw.t.backend.pipeline():
        for i, p in enumerate(payloads):
            tw.submit(("write", f"pw{i}", 0, p))
            seen = max(seen, len(tw.t.backend._inflight))
        assert tw.t.backend._inflight
    assert seen == 2
    assert tw.t.acks == [1, 2, 3, 4, 5]
    for i, p in enumerate(payloads):
        np.testing.assert_array_equal(tw.check_read(f"pw{i}", 0, 512), p)
    be = tw.t.backend
    assert len(be.extent_cache) == 0 and not be._projected
    assert not be._sim_chunk and not be._sim_refs
    tw.check_stores()


def test_pipeline_appends_chain_hinfo():          # test_ec_pipeline:453
    tw = Twin()
    parts = [_payload(40 + i, 256) for i in range(3)]
    with tw.j.backend.pipeline(), tw.t.backend.pipeline():
        for i, p in enumerate(parts):
            tw.submit(("write", "pchain", 256 * i, p))
    whole = np.concatenate(parts)
    np.testing.assert_array_equal(tw.check_read("pchain", 0, 768), whole)
    be = tw.t.backend
    hinfo = be.shards.get_hinfo(0, tw.t.oid("pchain"))
    shards = tutil.encode(be.sinfo, be.ec_impl, whole)
    for s in range(6):
        assert hinfo.get_chunk_hash(s) == tcrc.crc32c(shards[s].tobytes())
    tw.check_stores()


def test_pipeline_overlapping_writes_same_object():
    tw = Twin()
    base = _payload(31, 512)
    patch = _payload(32, 40)
    with tw.j.backend.pipeline(), tw.t.backend.pipeline():
        tw.submit(("write", "pover", 0, base))
        tw.submit(("write", "pover", 100, patch))
    expect = base.copy()
    expect[100:140] = patch
    np.testing.assert_array_equal(tw.check_read("pover", 0, 512), expect)
    tw.check_stores()


def test_delete_and_truncate():
    tw = Twin()
    tw.submit(("write", "d1", 0, _payload(50, 700)))
    tw.submit(("write", "d2", 0, _payload(51, 2000)))
    tw.submit(("truncate", "d2", 600))
    tw.submit(("delete", "d1"))
    tw.submit(("delete", "d2"), ("write", "d2", 0, _payload(52, 300)))
    tw.submit(("setattr", "d2", "user.x", b"y"))
    for side in (tw.j, tw.t):
        assert not side.backend.exists(side.oid("d1"))
    np.testing.assert_array_equal(tw.check_read("d2"), _payload(52, 300))
    tw.check_stores()


@pytest.mark.parametrize("down", [(0,), (0, 1), (2, 5)])
def test_degraded_reads(down):
    tw = Twin()
    p = _payload(60, 256 * 12 + 17)
    tw.submit(("write", "deg", 0, p))
    np.testing.assert_array_equal(tw.check_read("deg", down=down), p)
    np.testing.assert_array_equal(tw.check_read("deg", 100, 999, down=down),
                                  p[100:1099])
    tw.check_stores()


def test_big_appends_take_hier_entry():
    """Objects whose runs reach the hier threshold (128 KiB per shard):
    the port serves them with K2's hier entry (its plugin pinned at the
    combine="xla" point), mixed with a small one in one batch (the
    split path); stores still equal ceph_tpu's."""
    from ceph_tpu_torch.ops import autotune
    tw = Twin(k=4, m=2, chunk=4096)
    tw.t.backend.ec_impl._fused_point = dict(autotune.default_point(),
                                             combine="xla")
    with tw.j.backend.batch(), tw.t.backend.batch():
        tw.submit(("write", "big", 0, _payload(70, 4 * 128 * 1024 + 5)))
        tw.submit(("write", "small", 0, _payload(71, 3000)))
    assert tw.t.backend.fused_path == "hier_lsub+w32_flat"
    np.testing.assert_array_equal(tw.check_read("big", down=(1,)),
                                  _payload(70, 4 * 128 * 1024 + 5))
    tw.check_stores()


def test_writes_at_pinned_kernel_point():
    """The port's backend with its plugin pinned at a combine="kernel"
    point (K3's plain version here; a 1536-byte crc block that does not
    divide the 4 KiB chunk, so runs carry odd tails for the front pad)
    against ceph_tpu's ECBackend at its default: equal shard bytes,
    xattrs (HashInfo) and omap, through appends chained in a pipeline
    window, a mixed batch and an overwrite, and equal degraded reads."""
    tw = Twin(k=4, m=2, chunk=4096)
    point = {"tile": 8192, "wb": 384, "extract": "planar",
             "combine": "kernel"}
    tw.t.backend.ec_impl._fused_point = point
    paths = []
    with tw.j.backend.pipeline(), tw.t.backend.pipeline():
        for i in range(3):
            tw.submit(("write", "acc", i * 5 * 16384,
                       _payload(80 + i, 5 * 16384)))
            paths.append(tw.t.backend.fused_path)
    assert set(paths) == {"hier_acc"}
    with tw.j.backend.batch(), tw.t.backend.batch():
        tw.submit(("write", "accbig", 0, _payload(83, 7 * 16384 + 5)))
        tw.submit(("write", "accsmall", 0, _payload(84, 3000)))
    assert tw.t.backend.fused_path == "hier_acc+w32_flat"
    tw.submit(("write", "acc", 20000, _payload(85, 700)))
    whole = np.concatenate([_payload(80 + i, 5 * 16384) for i in range(3)])
    whole[20000:20700] = _payload(85, 700)
    np.testing.assert_array_equal(tw.check_read("acc", down=(0, 5)), whole)
    np.testing.assert_array_equal(tw.check_read("accbig", down=(2,)),
                                  _payload(83, 7 * 16384 + 5))
    tw.check_stores()
    hinfo = tw.t.backend.shards.get_hinfo(0, tw.t.oid("accbig"))
    assert hinfo.crc_valid

"""The write path's byte branch (Pallas kernel #6, `_gf_crc_kernel`,
served by K2's byte entry `gf_encode_with_crc`) on the CPU against
ceph_tpu: the entry against gf_encode_with_crc_xla (#6's XLA twin), the
extents submit/finalize with use_w32=False against ceph_tpu's extents
path on the CPU (the force_xla path, which has the same 2 KiB tile,
back pad and host tail), and the port's ECBackend on the branch
against ceph_tpu's.  Bytes and crcs must match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from ceph_tpu.ops import bitsliced as jbs
from ceph_tpu.ops import crc32c_linear as jcl
from ceph_tpu_torch.common import crc32c
from ceph_tpu_torch.ec import gf
from ceph_tpu_torch.ops import bitsliced as bs

CPU = torch.device("cpu")


def _tables(k, m):
    mat = gf.cauchy_rs_matrix(k, m)[k:]
    return mat, bs.tables_tensor(gf.product_tables(mat), CPU)


@pytest.mark.parametrize("k,m,n", [(8, 3, 8192), (4, 2, 3 * 2048),
                                   (10, 4, 2048)])
def test_byte_entry_matches_jax_xla_twin(k, m, n):
    mat, tab = _tables(k, m)
    chunks = np.random.default_rng(n + k).integers(0, 256, (k, n),
                                                   dtype=np.uint8)
    parity, bits = jbs.gf_encode_with_crc_xla(
        jnp.asarray(jbs.interleave_bitmatrix(mat), dtype=jnp.int8),
        jnp.asarray(jcl.crc_tile_matrix(2048)), jnp.asarray(chunks), m,
        tile=2048)
    want_l = jcl.bits_to_u32(np.asarray(bits)).astype(np.int64).T
    got_p, got_l = bs.gf_encode_with_crc(tab, torch.from_numpy(chunks))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(parity))
    assert got_l.shape == (k + m, n // 2048) and got_l.dtype == torch.int64
    np.testing.assert_array_equal(got_l.numpy(), want_l)


def test_byte_entry_refuses_partial_tiles():
    _, tab = _tables(4, 2)
    with pytest.raises(ValueError, match="multiple of the block"):
        bs.gf_encode_with_crc(tab, torch.zeros((4, 3000), dtype=torch.uint8))


@pytest.mark.parametrize("k,m,widths", [
    (8, 3, [8 * 65536]),                 # one 4 MiB object's run (k=8)
    (8, 3, [3000]),                      # a single run with an odd tail
    (8, 3, [8 * 65536, 8192, 3000, 100, 2048 * 5 + 7]),  # mixed widths
    (8, 3, [2048, 1]),
    (2, 1, [4 << 20, 3000 + 5]),         # a 4 MiB-wide run (k=2 bounds
])                                       # the CPU's memory)
def test_extents_byte_branch_matches_jax(k, m, widths):
    """No split and no hier entry on the byte branch, even with a run
    past the hier threshold: one launch, path "bytes"; every run's
    parity, body L, tail and body width equal ceph_tpu's."""
    mat, tab = _tables(k, m)
    rng = np.random.default_rng(sum(widths))
    runs = [rng.integers(0, 256, (k, w), dtype=np.uint8) for w in widths]
    h = bs.gf_encode_extents_with_crc_submit(tab, runs, use_w32=False)
    assert h["path"] == "bytes" and "split" not in h
    got = bs.gf_encode_extents_with_crc_finalize(h)
    want = jbs.gf_encode_extents_with_crc(
        jnp.asarray(jbs.interleave_bitmatrix(mat), dtype=jnp.int8), None,
        runs, m)
    assert len(got) == len(want) == len(runs)
    for (gp, gl, gt, gb), (wp, wl, wt, wb) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(np.asarray(gl, dtype=np.uint32),
                                      np.asarray(wl, dtype=np.uint32))
        np.testing.assert_array_equal(gt, wt)
        assert gb == wb


def test_plugin_byte_branch_skips_the_operating_point(monkeypatch):
    """With _use_w32 False the plugin takes the byte branch and never
    resolves its fused operating point (ceph_tpu's ec_jax.py:231,
    :248); its per-shard crcs are the host crc32c of the shards."""
    from ceph_tpu_torch.ops import autotune
    codec = tec.ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "4", "m": "2", "device": "cpu"})
    assert codec._use_w32 is True
    codec._use_w32 = False
    monkeypatch.setattr(autotune, "fused_operating_point",
                        lambda *a, **kw: pytest.fail("point consulted"))
    chunks = np.random.default_rng(9).integers(0, 256, (4, 5000),
                                               dtype=np.uint8)
    h = codec.encode_extents_with_crc_submit([chunks])
    assert h["path"] == "bytes"
    parity, crcs = codec.encode_chunks_with_crc(chunks)
    allsh = np.concatenate([chunks, parity])
    assert crcs == [crc32c.crc32c(row.tobytes()) for row in allsh]
    assert codec._fused_point is None


class _Perf:
    def __init__(self):
        self.n = {}

    def inc(self, key, by=1):
        self.n[key] = self.n.get(key, 0) + by

    def set(self, key, value):
        self.n[key] = value

    def tinc(self, key, dt):
        pass


def _backend(pkg, k, m, chunk, perf=None):
    ec, be, types, store_mod, util = pkg
    if ec is jec:
        codec = ec.ErasureCodePluginRegistry.instance().factory(
            "jax", {"k": str(k), "m": str(m)})
    else:
        codec = ec.ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": str(k), "m": str(m), "device": "cpu"})
        codec._use_w32 = False
    store = store_mod.MemStore()
    store.mount()
    shards = be.LocalShardBackend(store, types.pg_t(1, 0), k + m)
    backend = be.ECBackend(
        codec, util.StripeInfo(stripe_width=k * chunk, chunk_size=chunk),
        shards, perf=perf)
    return backend, store, shards


def test_backend_on_byte_branch_matches_jax():
    """The port's ECBackend with codec._use_w32 = False against
    ceph_tpu's (plugin jax on the CPU) under the same writes: equal
    shard bytes and xattrs (HashInfo), reads back, every HashInfo crc
    the host crc32c of the stored shard, and every drain counted as
    ec_fused_fallback_drains, as ceph_tpu counts a "bytes" drain."""
    k, m, chunk = 4, 2, 4096
    perf = _Perf()
    tb, tst, tsh = _backend((tec, tbe, ttypes, tstore, tutil), k, m, chunk,
                            perf)
    jb, jst, jsh = _backend((jec, jbe, jtypes, jstore, jutil), k, m, chunk)
    rng = np.random.default_rng(21)
    writes = [("a", 0, k * 128 * 1024 + 5), ("b", 0, 3000),
              ("c", 0, 2 * k * chunk), ("a", k * 128 * 1024 + 5, 700)]
    payloads = [rng.integers(0, 256, n, dtype=np.uint8)
                for _, _, n in writes]
    for be, ect, types in ((tb, tect, ttypes), (jb, ject, jtypes)):
        with be.pipeline():
            for v, ((name, off, _), p) in enumerate(zip(writes, payloads)):
                txn = ect.PGTransaction()
                txn.write(types.hobject_t(pool=1, name=name), off, p)
                be.submit_transaction(txn, types.eversion_t(1, v + 1),
                                      lambda: None)
        with be.batch():
            for name in ("d", "e"):
                txn = ect.PGTransaction()
                txn.write(types.hobject_t(pool=1, name=name), 0,
                          payloads[1 if name == "d" else 2])
                be.submit_transaction(txn, types.eversion_t(2, ord(name)),
                                      lambda: None)
    assert tb.fused_path == "bytes"
    # three whole-object writes and the batch; the unaligned append to
    # "a" is a read-modify-write, encoded without a crc
    assert perf.n.get("ec_fused_fallback_drains") == 4
    assert not perf.n.get("ec_fused_kernel_drains")
    expect = {"a": np.concatenate(payloads[::3]), "b": payloads[1],
              "c": payloads[2], "d": payloads[1], "e": payloads[2]}
    for name, data in expect.items():
        toid = ttypes.hobject_t(pool=1, name=name)
        np.testing.assert_array_equal(tb.read(toid), data)
        hinfo = tsh.get_hinfo(0, toid)
        # the read-modify-write invalidates "a"'s crcs, as in ceph_tpu
        assert hinfo.crc_valid == (name != "a")
        for s in range(k + m):
            cid = tsh.cids[s]
            goid = tect.shard_oid(toid, s)
            stored = tst.read(cid, goid)
            if hinfo.crc_valid:
                assert hinfo.get_chunk_hash(s) == \
                    crc32c.crc32c(stored.tobytes())
            jgoid = ject.shard_oid(jtypes.hobject_t(pool=1, name=name), s)
            np.testing.assert_array_equal(stored, jst.read(jsh.cids[s],
                                                           jgoid))
            assert tst.getattrs(cid, goid) == jst.getattrs(jsh.cids[s], jgoid)

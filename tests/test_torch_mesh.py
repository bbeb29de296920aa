"""The port's sharded stripe codec (ceph_tpu_torch/parallel/mesh.py)
against the JAX package's, on the same seeded inputs: the scenarios of
tests/test_parallel.py (the graft-entry test excepted) replayed on both.
The JAX side runs on the 8 virtual CPU devices tests/conftest.py sets
up; the port on a mesh that repeats the "cpu" device, of the same
shape.  encode_flat / encode, decode_flat / decode_flat_batch,
clay_repair_batch at k8m4d11 and k8m3d10 with small sub-chunks, and the
ECBackend drain and recover_shard through a mesh must give equal bytes
and equal ec_mesh_* counters."""

import numpy as np
import pytest
import torch

import ceph_tpu.ec as jec
import ceph_tpu.osd.ec_backend as jbe
import ceph_tpu.osd.ec_transaction as ject
import ceph_tpu.osd.ec_util as jutil
import ceph_tpu.osd.types as jtypes
import ceph_tpu.parallel.mesh as jmesh
import ceph_tpu.store as jstore
import ceph_tpu.store.object_store as jos
import ceph_tpu_torch.ec as tec
import ceph_tpu_torch.osd.ec_backend as tbe
import ceph_tpu_torch.osd.ec_transaction as tect
import ceph_tpu_torch.osd.ec_util as tutil
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.parallel.mesh as tmesh
import ceph_tpu_torch.store as tstore
import ceph_tpu_torch.store.object_store as tos
from ceph_tpu_torch.ec import gf

SHAPES = [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2), (8, 1), (2, 4)]
MESH_COUNTERS = ("ec_mesh_drains", "ec_mesh_repair_launches",
                 "ec_mesh_errors")


def _codecs(k, m, shape, technique="cauchy"):
    s, d = shape
    port = tmesh.DistributedStripeCodec(
        k, m, tmesh.make_mesh(s, d, ["cpu"] * (s * d)), technique)
    ref = jmesh.DistributedStripeCodec(k, m, jmesh.make_mesh(s, d),
                                       technique)
    return port, ref


def _plugin(port, k, m):
    if port:
        return tec.ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": str(k), "m": str(m), "device": "cpu"})
    return jec.ErasureCodePluginRegistry.instance().factory(
        "jax", {"k": str(k), "m": str(m), "technique": "cauchy"})


def test_make_mesh_layout_and_gather():
    mesh = tmesh.make_mesh(4, 2, ["cpu"] * 8)
    assert mesh.shape == {"shard": 4, "data": 2}
    assert mesh.gather == "local"
    assert mesh.column(1) == [torch.device("cpu")] * 4
    assert tmesh.make_mesh(1, 2, ["cpu"] * 2).gather == "none"
    with pytest.raises(ValueError, match="need 8 devices"):
        tmesh.make_mesh(4, 2, ["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.DistributedStripeCodec(6, 2, mesh)


@pytest.mark.parametrize("n_shard,n_data", SHAPES)
def test_distributed_encode_matches_jax(n_shard, n_data):
    k, m = 8, 3
    port, ref = _codecs(k, m, (n_shard, n_data))
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    rng = np.random.default_rng(42)
    stripes = rng.integers(0, 256, (2 * n_data, k, 256), dtype=np.uint8)
    got = port.encode(stripes)
    np.testing.assert_array_equal(got, np.asarray(ref.encode(stripes)))
    np.testing.assert_array_equal(got, port.encode_reference(stripes))
    # a ragged width pads to the byte-axis quantum and is cropped
    flat = rng.integers(0, 256, (k, 1000 + n_data), dtype=np.uint8)
    got = port.encode_flat(flat)
    np.testing.assert_array_equal(got, np.asarray(ref.encode_flat(flat)))
    h = port.encode_flat_submit(flat)
    np.testing.assert_array_equal(port.encode_flat_finalize(h), got)
    words = torch.from_numpy(flat[:, :16 * n_data * 4].copy())
    np.testing.assert_array_equal(port.encode_words(words).numpy(),
                                  got[:, :16 * n_data * 4])


@pytest.mark.parametrize("n_shard,n_data", SHAPES)
def test_distributed_decode_matches_jax(n_shard, n_data):
    """Sharded inverted-matrix rebuild == the original shards and the
    JAX mesh's, single object (decode_flat, decode) and a batch of
    mixed widths (decode_flat_batch)."""
    k, m = 8, 3
    port, ref = _codecs(k, m, (n_shard, n_data))
    rng = np.random.default_rng(7)
    stripes = rng.integers(0, 256, (4, k, 256), dtype=np.uint8)
    full = np.concatenate([stripes, port.encode(stripes)], axis=1)
    erased = (1, 5, 9)
    survivors = tuple(s for s in range(k + m) if s not in erased)[:k]
    avail = full[:, list(survivors), :]
    got = port.decode(avail, survivors, erased)
    np.testing.assert_array_equal(got, full[:, list(erased), :])
    np.testing.assert_array_equal(
        got, np.asarray(ref.decode(avail, survivors, erased)))
    avail_list, want = [], []
    for w in (512, 1024, 1536):
        d = rng.integers(0, 256, (k, w), dtype=np.uint8)
        dense = np.concatenate([d, gf.gf_matvec(port.matrix[k:], d)])
        avail_list.append(dense[list(survivors)])
        want.append(dense[list(erased)])
    out = port.decode_flat_batch(avail_list, survivors, erased)
    ref_out = ref.decode_flat_batch(avail_list, survivors, erased)
    assert len(out) == 3
    for got, exp, r, av in zip(out, want, ref_out, avail_list):
        np.testing.assert_array_equal(got, exp)
        np.testing.assert_array_equal(got, np.asarray(r))
        np.testing.assert_array_equal(
            port.decode_flat(av, survivors, erased), exp)
    assert port.decode_flat_batch([], survivors, erased) == []
    with pytest.raises(ValueError, match="exactly k"):
        port.decode_flat(avail_list[0], survivors[:-1], erased)


def test_distributed_matches_plugins_bytes():
    """Mesh parity == the port's torch plugin == the JAX plugin, bit
    for bit (test_parallel's jax-plugin parity test, both sides)."""
    port, ref = _codecs(4, 2, (2, 2))
    rng = np.random.default_rng(43)
    stripes = rng.integers(0, 256, (4, 4, 128), dtype=np.uint8)
    got = port.encode(stripes)
    np.testing.assert_array_equal(got, np.asarray(ref.encode(stripes)))
    plug = _plugin(True, 4, 2)
    np.testing.assert_array_equal(
        got, plug.encode_stripes(torch.from_numpy(stripes)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(_plugin(False, 4, 2).encode_stripes(stripes)))


def test_distributed_w32_and_byte_meshes_match_port():
    """The JAX mesh's w32 (interpret) and byte formulations and the
    port's mesh agree bit for bit."""
    k, m = 4, 2
    port = tmesh.DistributedStripeCodec(
        k, m, tmesh.make_mesh(2, 2, ["cpu"] * 4))
    mesh = jmesh.make_mesh(2, 2)
    c_byte = jmesh.DistributedStripeCodec(k, m, mesh, use_w32=False)
    c_w32 = jmesh.DistributedStripeCodec(k, m, mesh, use_w32=True,
                                         interpret=True)
    flat = np.random.default_rng(11).integers(0, 256, (k, 2048),
                                              dtype=np.uint8)
    got = port.encode_flat(flat)
    np.testing.assert_array_equal(got, c_byte.encode_flat(flat))
    np.testing.assert_array_equal(got, c_w32.encode_flat(flat))


@pytest.mark.parametrize("port_side", [True, False], ids=["port", "jax"])
def test_distributed_decode_matches_single_card_plugin(port_side):
    """Mesh repair == the same package's single-device plugin
    decode_chunks, bit for bit, and the two packages agree."""
    k, m = 4, 2
    port, ref = _codecs(k, m, (2, 4))
    codec = _plugin(port_side, k, m)
    rng = np.random.default_rng(13)
    chunks = rng.integers(0, 256, (k, 1024), dtype=np.uint8)
    dense = np.concatenate([chunks, np.asarray(codec.encode_chunks(chunks))])
    erased = [0, 4]
    survivors = tuple(s for s in range(k + m) if s not in erased)[:k]
    single = codec.decode_chunks(
        np.where(np.isin(np.arange(k + m), erased)[:, None], 0, dense),
        erased)
    mc = port if port_side else ref
    meshed = mc.decode_flat(dense[list(survivors)], survivors, erased)
    for i, e in enumerate(erased):
        np.testing.assert_array_equal(meshed[i], single[e])


@pytest.mark.parametrize("n_shard,n_data", [(1, 1), (4, 1), (2, 2),
                                            (4, 2)])
@pytest.mark.parametrize("k,m,d", [(8, 4, 11), (8, 3, 10)])
def test_clay_repair_batch_matches_jax(k, m, d, n_shard, n_data):
    """clay_repair_batch (the repair matrix's input rows zero-padded to
    the shard axis, K4's plain version where a shard's tables pass K1's
    shared memory) equals the JAX mesh's, the plan's host apply and the
    lost chunk, over three objects of small sub-chunks."""
    prof = {"k": str(k), "m": str(m), "d": str(d)}
    pc = tec.ErasureCodePluginRegistry.instance().factory("clay", prof)
    jc = jec.ErasureCodePluginRegistry.instance().factory("clay", prof)
    port, ref = _codecs(k, m, (n_shard, n_data))
    n, sub = k + m, pc.get_sub_chunk_count()
    lost = 2
    plan = tmesh.ClayRepairPlan.build(pc, lost, device="cpu")
    ref_plan = jmesh.ClayRepairPlan.build(jc, lost)
    planes = pc.repair_planes(lost)
    rng = np.random.default_rng(d + n_shard)
    rows_list, lost_chunks = [], []
    for w in (8, 16, 3):
        enc = pc.encode(set(range(n)), rng.integers(
            0, 256, k * sub * w, dtype=np.uint8).tobytes())
        helpers = {ch: np.asarray(enc[ch]).reshape(sub, w)[planes]
                   for ch in plan.helper_ids}
        rows_list.append(pc.repair_rows(lost, helpers))
        lost_chunks.append(np.asarray(enc[lost]))
    got = port.clay_repair_batch(plan, rows_list)
    want = ref.clay_repair_batch(ref_plan, rows_list)
    assert len(got) == 3
    for g, w_, rows, chunk in zip(got, want, rows_list, lost_chunks):
        np.testing.assert_array_equal(g, np.asarray(w_))
        np.testing.assert_array_equal(g, plan.apply_host(rows))
        np.testing.assert_array_equal(g.reshape(-1), chunk)
    assert port.clay_repair_batch(plan, []) == []
    # one set of per-shard tables per plan signature
    assert list(port._clay_plans) == [plan.signature]


class Side:
    def __init__(self, port: bool):
        self.port = port
        (self.be, self.ect, self.util, self.types, self.store, self.os) = \
            (tbe, tect, tutil, ttypes, tstore, tos) if port \
            else (jbe, ject, jutil, jtypes, jstore, jos)

    def oid(self, name):
        return self.types.hobject_t(pool=1, name=name)

    def backend(self, k, m, chunk, mesh_codec, **kw):
        store = self.store.MemStore()
        store.mount()
        shards = self.be.LocalShardBackend(store, self.types.pg_t(1, 0),
                                           k + m)
        be = self.be.ECBackend(_plugin(self.port, k, m),
                               self.util.StripeInfo(k * chunk, chunk),
                               shards, mesh_codec=mesh_codec, **kw)
        return be, store


def _mesh_counters(be):
    dump = be.perf.dump()
    return {c: dump[c] for c in MESH_COUNTERS}


def _drain(side, mesh_codec, payloads, k, m, chunk):
    be, store = side.backend(k, m, chunk, mesh_codec)
    acked = []
    with be.batch():                   # one batched drain, 4 ops
        for i, data in enumerate(payloads):
            txn = side.ect.PGTransaction()
            txn.write(side.oid(f"obj{i}"), 0, data)
            be.submit_transaction(txn, side.types.eversion_t(1, i + 1),
                                  lambda i=i: acked.append(i))
    assert sorted(acked) == list(range(len(payloads)))
    for i, data in enumerate(payloads):
        np.testing.assert_array_equal(be.read(side.oid(f"obj{i}")), data)
    shards = {}
    for cid in store.list_collections():
        for goid in store.list_objects(cid):
            shards[(str(cid), str(goid))] = store.read(cid, goid).copy()
    return be, shards


def test_pipeline_drain_through_mesh():
    """ECBackend with a mesh codec: the drain's parity comes from the
    sharded contraction, every shard object byte-identical to the
    single-device plane's and to the JAX backend's, with equal
    ec_mesh_* counters."""
    k, m, chunk = 4, 2, 64
    port, ref = _codecs(k, m, (2, 4))
    rng = np.random.default_rng(17)
    payloads = [rng.integers(0, 256, 3 * k * chunk, dtype=np.uint8)
                for _ in range(4)]
    results = {}
    for side in (Side(True), Side(False)):
        mc = port if side.port else ref
        single_be, single = _drain(side, None, payloads, k, m, chunk)
        mesh_be, meshed = _drain(side, mc, payloads, k, m, chunk)
        assert mesh_be.mesh_codec is mc and mesh_be.batched_extents == 4
        assert single.keys() == meshed.keys()
        for key in single:
            np.testing.assert_array_equal(single[key], meshed[key])
        results[side.port] = (meshed, _mesh_counters(mesh_be))
        assert _mesh_counters(single_be)["ec_mesh_drains"] == 0
    (pshards, pcount), (jshards, jcount) = results[True], results[False]
    assert pcount == jcount and pcount["ec_mesh_drains"] == 1
    assert sorted(pshards) == sorted(jshards)
    for key in pshards:
        np.testing.assert_array_equal(pshards[key], jshards[key])


def test_mesh_recover_shard():
    """recover_shard with a mesh codec rebuilds lost shards through the
    distributed decode; the pushed bytes equal the originals on both
    packages, with equal counters."""
    k, m, chunk = 4, 2, 64
    port, ref = _codecs(k, m, (2, 4))
    data = np.random.default_rng(19).integers(0, 256, 2 * k * chunk,
                                              dtype=np.uint8)
    got = {}
    for side in (Side(True), Side(False)):
        be, store = side.backend(k, m, chunk, port if side.port else ref)
        o = side.oid("victim")
        txn = side.ect.PGTransaction()
        txn.write(o, 0, data)
        done = []
        be.submit_transaction(txn, side.types.eversion_t(1, 1),
                              lambda: done.append(1))
        assert done
        orig = {s: store.read(be.shards.cids[s],
                              side.ect.shard_oid(o, s)).copy()
                for s in (1, 4)}
        for s in (1, 4):
            t = side.os.Transaction()
            t.remove(side.ect.shard_oid(o, s))
            store.queue_transactions(be.shards.cids[s], [t])
        pushed = {}
        be.recover_shard(o, [1, 4],
                         lambda s, d, h: pushed.__setitem__(s, d))
        assert set(pushed) == {1, 4}
        for s in (1, 4):
            np.testing.assert_array_equal(pushed[s], orig[s])
        got[side.port] = (pushed, _mesh_counters(be))
    assert got[True][1] == got[False][1]
    assert got[True][1]["ec_mesh_repair_launches"] == 1
    for s in (1, 4):
        np.testing.assert_array_equal(got[True][0][s], got[False][0][s])

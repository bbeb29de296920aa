"""The port's CLAY plugin (ceph_tpu_torch/ec/plugins/ec_clay.py) and
its repair plan (ceph_tpu_torch/parallel/mesh.ClayRepairPlan) against
the JAX package's, on the same seeded inputs: geometry, encode, decode,
repair, the repair matrix, its signature and helper order, then the
plan's host apply, its apply on the CPU (K4's plain version) and its
batch against the JAX plan and codec.repair for every lost chunk
(the port of tests/test_clay.py's lowering test).  Bytes must match
exactly."""

import errno
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu.parallel.mesh import ClayRepairPlan as JaxPlan
from ceph_tpu_torch.common import util
from ceph_tpu_torch.ec import ErasureCodeError, ErasureCodePluginRegistry
from ceph_tpu_torch.ec.plugins import ec_clay
from ceph_tpu_torch.parallel import ClayRepairPlan

PROFILES = [(4, 2, 5), (8, 4, 11), (8, 3, 10)]
SUB_SIZE = 8                    # bytes a sub-chunk: small, and a ragged 8


def _pair(k, m, d):
    prof = {"k": str(k), "m": str(m), "d": str(d)}
    return (ErasureCodePluginRegistry.instance().factory("clay", prof),
            JaxRegistry.instance().factory("clay", prof))


def _payload(codec, seed, sub_size=SUB_SIZE):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, codec.k * codec.get_sub_chunk_count()
                        * sub_size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("k,m,d", PROFILES)
def test_clay_geometry_matches_jax(k, m, d):
    port, jax = _pair(k, m, d)
    assert isinstance(port, ec_clay.ErasureCodeClay)
    for attr in ("k", "m", "d", "q", "t", "nu", "sub_chunks", "N"):
        assert getattr(port, attr) == getattr(jax, attr), attr
    np.testing.assert_array_equal(port.H, jax.H)
    assert port.get_alignment() == jax.get_alignment()
    for width in (1, 4096, 4 << 20, 12345):
        assert port.get_chunk_size(width) == jax.get_chunk_size(width)
    n = k + m
    for lost in range(n):
        assert port.repair_planes(lost) == jax.repair_planes(lost)
        avail = set(range(n)) - {lost}
        assert port.choose_helpers(lost, avail) == \
            jax.choose_helpers(lost, avail)
        assert port.minimum_to_decode({lost}, avail) == \
            jax.minimum_to_decode({lost}, avail)
    want, avail = {0, 1}, set(range(2, n))
    assert port.minimum_to_decode(want, avail) == \
        jax.minimum_to_decode(want, avail)


@pytest.mark.parametrize("k,m,d", PROFILES)
def test_clay_encode_decode_match_jax(k, m, d):
    port, jax = _pair(k, m, d)
    n = k + m
    payload = _payload(port, 10 * k + m)
    enc = port.encode(set(range(n)), payload)
    ref = jax.encode(set(range(n)), payload)
    for i in range(n):
        np.testing.assert_array_equal(enc[i], ref[i])
    cs = len(enc[0])
    rng = np.random.default_rng(d)
    patterns = list(itertools.combinations(range(n), m))
    for idx in rng.choice(len(patterns), size=min(6, len(patterns)),
                          replace=False):
        lost = set(patterns[idx])
        avail = {i: enc[i] for i in range(n) if i not in lost}
        got = port.decode(set(range(n)), avail, cs)
        want = jax.decode(set(range(n)), avail, cs)
        for i in range(n):
            np.testing.assert_array_equal(got[i], want[i])
            np.testing.assert_array_equal(got[i], enc[i])


@pytest.mark.parametrize("k,m,d", PROFILES)
def test_clay_repair_and_its_matrix_match_jax(k, m, d):
    port, jax = _pair(k, m, d)
    n = k + m
    sub = port.get_sub_chunk_count()
    enc = port.encode(set(range(n)), _payload(port, 7 * d))
    for lost in range(n):
        order = port.repair_helper_order(lost)
        assert order == jax.repair_helper_order(lost)
        assert port.repair_signature(lost) == jax.repair_signature(lost)
        planes = port.repair_planes(lost)
        helpers = {ch: np.asarray(enc[ch]).reshape(sub, SUB_SIZE)[planes]
                   for ch in order}
        rebuilt = port.repair(lost, helpers, SUB_SIZE)
        np.testing.assert_array_equal(rebuilt,
                                      jax.repair(lost, helpers, SUB_SIZE))
        np.testing.assert_array_equal(rebuilt, enc[lost])
        mat = port.repair_matrix(lost)
        assert mat.shape == (sub, d * len(planes))
        np.testing.assert_array_equal(mat, jax.repair_matrix(lost))
        np.testing.assert_array_equal(port.repair_rows(lost, helpers),
                                      jax.repair_rows(lost, helpers))


@pytest.mark.parametrize("k,m,d", PROFILES)
def test_clay_plan_matches_jax_plan_for_every_lost_chunk(k, m, d):
    """The port's ClayRepairPlan on the CPU (K4's plain version) against
    the JAX plan's host apply and codec.repair, one object and a batch
    of three objects of other widths, for every single lost chunk."""
    port, jax = _pair(k, m, d)
    n = k + m
    sub = port.get_sub_chunk_count()
    widths = (SUB_SIZE, 16, 3)
    encs = [port.encode(set(range(n)), _payload(port, 100 + i, w))
            for i, w in enumerate(widths)]
    for lost in range(n):
        plan = ClayRepairPlan.build(port, lost, device="cpu")
        ref_plan = JaxPlan.build(jax, lost)
        assert plan.signature == ref_plan.signature
        assert plan.helper_ids == ref_plan.helper_ids
        assert (plan.out_rows, plan.in_rows) == \
            (ref_plan.out_rows, ref_plan.in_rows) == \
            (sub, d * len(port.repair_planes(lost)))
        np.testing.assert_array_equal(plan.matrix, ref_plan.matrix)
        planes = port.repair_planes(lost)
        rows_list, refs = [], []
        for enc, w in zip(encs, widths):
            helpers = {ch: np.asarray(enc[ch]).reshape(sub, w)[planes]
                       for ch in plan.helper_ids}
            rows_list.append(port.repair_rows(lost, helpers))
            refs.append(jax.repair(lost, helpers, w))
            np.testing.assert_array_equal(refs[-1], enc[lost])
        rows = rows_list[0]
        np.testing.assert_array_equal(plan.apply_host(rows),
                                      ref_plan.apply_host(rows))
        got = plan.apply_device(rows)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got.reshape(-1), refs[0])
        np.testing.assert_array_equal(plan.apply(rows).reshape(-1), refs[0])
        batch = plan.apply_batch(rows_list)
        assert len(batch) == len(widths)
        for out, ref in zip(batch, refs):
            np.testing.assert_array_equal(out.reshape(-1), ref)
        assert plan.apply_batch([]) == []


def test_clay_plan_tables_built_once_and_no_host_fallback(monkeypatch):
    """The product tables are built once, on the plan's device; a failing
    device apply raises instead of falling back to the host (the
    reference's apply() swallows it)."""
    from ceph_tpu_torch.ops import bitsliced as bs
    port, _ = _pair(4, 2, 5)
    plan = ClayRepairPlan.build(port, 0, device="cpu")
    tab = plan.tables_tensor()
    assert tab.shape == (plan.out_rows, plan.in_rows, 256)
    assert tab.device == plan.device == torch.device("cpu")
    assert plan.tables_tensor() is tab
    rows = np.zeros((plan.in_rows, 8), dtype=np.uint8)

    def broken(tables, chunks, tile=None, groups=None):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(bs, "gf_bitmatmul_stream", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        plan.apply(rows)
    with pytest.raises(RuntimeError, match="launch failed"):
        plan.apply_batch([rows])


def test_clay_registry_and_bad_profiles():
    reg = ErasureCodePluginRegistry.instance()
    for d in (6, 4, 3):
        with pytest.raises(ErasureCodeError) as e:
            reg.factory("clay", {"k": "4", "m": "2", "d": str(d)})
        assert e.value.errno == errno.EINVAL


def test_concat_and_split_columns_match_jax():
    from ceph_tpu.common import util as jutil
    rng = np.random.default_rng(5)
    arrs = [rng.integers(0, 256, (3, w), dtype=np.uint8) for w in (4, 1, 7)]
    big, widths = util.concat_columns(arrs)
    jbig, jwidths = jutil.concat_columns(arrs)
    np.testing.assert_array_equal(big, jbig)
    assert widths == jwidths == [4, 1, 7]
    for a, b, c in zip(util.split_columns(big, widths),
                       jutil.split_columns(jbig, jwidths), arrs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    one, w1 = util.concat_columns(arrs[:1])
    assert one is arrs[0] and w1 == [4]

"""The port's CPU erasure-code plugins (isa, jerasure, example), its
copy of the bitmatrix codes and its GF(2^8) host helpers, each against
its ceph_tpu twin on the same profile and inputs: encode, decode of
every erasure set up to m, isa's XOR fast path and decode-table cache,
the errno of bad profiles, and the native gf_matvec against the numpy
path."""

import itertools

import numpy as np
import pytest

import ceph_tpu.ec as jec
from ceph_tpu.ec import bitmatrix as jbm
from ceph_tpu.ec import gf as jgf
from ceph_tpu_torch.common import native
from ceph_tpu_torch.ec import ErasureCodeError, ErasureCodePluginRegistry, gf
from ceph_tpu_torch.ec import bitmatrix as bm
from ceph_tpu_torch.ec.plugins import ec_isa

PROFILES = [
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"}),
    ("jerasure", {"k": "6", "m": "3", "technique": "reed_sol_van"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_r6_op"}),
    ("jerasure", {"k": "6", "m": "3", "technique": "cauchy_orig"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_good"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "liberation", "w": "7"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "blaum_roth", "w": "6"}),
    ("jerasure", {"k": "6", "m": "2", "technique": "liber8tion"}),
    ("isa", {"k": "4", "m": "2"}),
    ("isa", {"k": "6", "m": "3", "technique": "cauchy"}),
    ("example", {}),
]


def _pair(plugin, profile):
    jc = jec.ErasureCodePluginRegistry.instance().factory(plugin,
                                                         dict(profile))
    tc = ErasureCodePluginRegistry.instance().factory(plugin, dict(profile))
    return jc, tc


def _ids(cases):
    return [p + "/" + ",".join(f"{k}={v}" for k, v in sorted(prof.items()))
            for p, prof in cases]


@pytest.mark.parametrize("plugin,profile", PROFILES, ids=_ids(PROFILES))
def test_plugin_matches_jax_twin(plugin, profile):
    """Encode, then decode of every erasure set of 1 .. m chunks,
    against the JAX package's plugin of the same name."""
    jc, tc = _pair(plugin, profile)
    n, k = tc.get_chunk_count(), tc.get_data_chunk_count()
    assert (n, k) == (jc.get_chunk_count(), jc.get_data_chunk_count())
    assert tc.get_chunk_size(5000) == jc.get_chunk_size(5000)
    data = np.random.default_rng(n * 31 + k).integers(
        0, 256, k * tc.get_chunk_size(5000) - 17, dtype=np.uint8)
    want = jc.encode(set(range(n)), data)
    got = tc.encode(set(range(n)), data)
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i])
    cs = len(got[0])
    for e in range(1, n - k + 1):
        for erased in itertools.combinations(range(n), e):
            avail = {i: got[i] for i in range(n) if i not in erased}
            dec = tc.decode(set(range(n)), avail, cs)
            jdec = jc.decode(set(range(n)), dict(avail), cs)
            for i in range(n):
                np.testing.assert_array_equal(dec[i], got[i])
                np.testing.assert_array_equal(dec[i], jdec[i])
    with pytest.raises(ErasureCodeError, match="cannot decode"):
        tc.decode(set(range(n)), {i: got[i] for i in range(k - 1)}, cs)


def test_example_prefers_the_cheapest_chunks():
    jc, tc = _pair("example", {})
    cost = {0: 5, 1: 1, 2: 1}
    assert tc.minimum_to_decode_with_cost({0}, cost) == {1, 2} == \
        jc.minimum_to_decode_with_cost({0}, cost)
    with pytest.raises(ErasureCodeError):
        tc.minimum_to_decode_with_cost({0}, {1: 1})


def test_isa_xor_fast_path_and_table_cache(monkeypatch):
    """One lost data chunk with a 0/1 decode row (reed_sol_van at k=3,
    m=2, whose first parity row is all ones) is rebuilt by XOR alone,
    without gf_matvec;
    repeated erasure signatures hit the LRU decode-table cache, with the
    hit/miss counts of ceph_tpu's cache for the same sequence."""
    from ceph_tpu.ec.plugins import ec_isa as jisa
    cache = ec_isa.DecodeTableCache()
    jcache = jisa.DecodeTableCache()
    monkeypatch.setattr(ec_isa, "_TABLE_CACHE", cache)
    monkeypatch.setattr(jisa, "_TABLE_CACHE", jcache)
    jc, tc = _pair("isa", {"k": "3", "m": "2"})
    data = np.random.default_rng(5).integers(0, 256, 3 * 4096,
                                             dtype=np.uint8)
    enc = tc.encode(set(range(5)), data)
    cs = len(enc[0])
    real = ec_isa.gf.gf_matvec
    calls = []

    def spy(mat, chunks):
        calls.append(mat.shape)
        return real(mat, chunks)
    monkeypatch.setattr(ec_isa.gf, "gf_matvec", spy)
    # (3, 4) loses parity only: re-encoded, no decode table
    sequence = [(0,), (0,), (1, 2), (2,), (1, 2), (3, 4)]
    for erased in sequence:
        avail = {i: enc[i] for i in range(5) if i not in erased}
        calls.clear()
        dec = tc.decode(set(range(5)), avail, cs)
        jdec = jc.decode(set(range(5)), dict(avail), cs)
        for i in range(5):
            np.testing.assert_array_equal(dec[i], enc[i])
            np.testing.assert_array_equal(jdec[i], enc[i])
        if len(erased) == 1:
            assert calls == []               # XOR only
    assert (cache.hits, cache.misses) == (jcache.hits, jcache.misses) == \
        (2, 3)


def test_isa_cache_is_lru():
    cache = ec_isa.DecodeTableCache(capacity=2)
    for key in ("a", "b", "a", "c"):
        if cache.get(key) is None:
            cache.put(key, np.zeros(1))
    assert cache.get("b") is None and cache.get("a") is not None
    assert (cache.hits, cache.misses) == (2, 4)


BAD = [
    ("jerasure", {"k": "0"}),
    ("jerasure", {"k": "4", "m": "0"}),
    ("jerasure", {"k": "200", "m": "100"}),
    ("jerasure", {"k": "4", "m": "3", "technique": "reed_sol_r6_op"}),
    ("jerasure", {"k": "4", "technique": "nosuch"}),
    ("jerasure", {"k": "4", "m": "3", "technique": "liberation"}),
    ("jerasure", {"k": "4", "technique": "liberation", "w": "8"}),
    ("jerasure", {"k": "8", "technique": "liberation", "w": "5"}),
    ("jerasure", {"k": "4", "technique": "blaum_roth", "w": "7"}),
    ("jerasure", {"k": "9", "technique": "liber8tion"}),
    ("jerasure", {"k": "x"}),
    ("isa", {"k": "0"}),
    ("isa", {"technique": "cauchy_good"}),
]


@pytest.mark.parametrize("plugin,profile", BAD, ids=_ids(BAD))
def test_bad_profiles_raise_the_jax_errno(plugin, profile):
    with pytest.raises(jec.ErasureCodeError) as jerr:
        jec.ErasureCodePluginRegistry.instance().factory(plugin,
                                                         dict(profile))
    with pytest.raises(ErasureCodeError) as err:
        ErasureCodePluginRegistry.instance().factory(plugin, dict(profile))
    assert err.value.errno == jerr.value.errno


@pytest.mark.parametrize("r,k,n", [(3, 8, 4096), (2, 6, 1024), (4, 4, 5000),
                                   (3, 8, 1023)])
def test_gf_matvec_native_matches_numpy(monkeypatch, r, k, n):
    rng = np.random.default_rng(r * k + n)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    mat[0, 0], mat[-1, -1] = 0, 1              # the 0 and 1 shortcuts
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    assert native.available()
    got = gf.gf_matvec(mat, chunks)
    np.testing.assert_array_equal(got, jgf.gf_matvec(mat, chunks))
    monkeypatch.setattr(native, "gf8_matvec", lambda *a: None)
    np.testing.assert_array_equal(gf.gf_matvec(mat, chunks), got)


def test_gf_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    for a, b in rng.integers(0, 256, (200, 2)):
        if b:
            assert gf.gf_div(int(a), int(b)) == jgf.gf_div(int(a), int(b))
    with pytest.raises(ZeroDivisionError):
        gf.gf_div(3, 0)
    data = rng.integers(0, 256, 999, dtype=np.uint8)
    for c in (0, 1, 2, 142, 255):
        np.testing.assert_array_equal(gf.gf_mul_region(c, data),
                                      jgf.gf_mul_region(c, data))
    mat = gf.cauchy_rs_matrix(6, 3)[6:]
    chunks = rng.integers(0, 256, (6, 300), dtype=np.uint8)
    bitmat = gf.expand_to_bitmatrix(mat)
    np.testing.assert_array_equal(gf.bitmatrix_matvec(bitmat, chunks),
                                  jgf.bitmatrix_matvec(bitmat, chunks))
    np.testing.assert_array_equal(gf.bitmatrix_matvec(bitmat, chunks),
                                  gf.gf_matvec(mat, chunks))


@pytest.mark.parametrize("technique,k,w", [("liberation", 5, 7),
                                           ("blaum_roth", 6, 6),
                                           ("liber8tion", 8, 8)])
def test_bitmatrix_codes_match_jax(technique, k, w):
    np.testing.assert_array_equal(bm.coding_matrix(technique, k, w),
                                  jbm.coding_matrix(technique, k, w))
    gen = bm.generator(technique, k, w)
    chunks = np.random.default_rng(k).integers(0, 256, (k, 64 * w),
                                               dtype=np.uint8)
    dense = np.concatenate([chunks, bm.encode(gen[k * w:], chunks, w)])
    for erased in ([0, 1], [1, k], [k, k + 1]):
        holed = dense.copy()
        holed[erased] = 0
        np.testing.assert_array_equal(bm.decode(gen, holed, erased, k, w),
                                      dense)

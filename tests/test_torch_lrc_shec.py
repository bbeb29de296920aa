"""The port's LRC and SHEC plugins (ceph_tpu_torch/ec/plugins/ec_lrc.py,
ec_shec.py) against the JAX package's on the same seeded inputs: every
scenario of tests/test_lrc_shec.py replayed on both sides.  Encoded
bytes, decode_chunks for every single and double erasure (the rows
and the set of chunks left unsolved), decode, minimum_to_decode,
minimum_to_decode_with_cost and the chunk mapping must be equal, and a
bad profile must raise on both sides with the same errno."""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import ErasureCodeError as JaxError
from ceph_tpu.ec import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch.ec import ErasureCodeError, ErasureCodePluginRegistry
from ceph_tpu_torch.ec.plugins import ec_lrc, ec_shec

LAYERED = {
    "plugin": "lrc",
    "mapping": "__DD__DD",
    "layers": '[["_cDD_cDD",""],["cDDD____",""],["____cDDD",""]]',
}
OVERRIDE = {
    "plugin": "lrc", "mapping": "DD_",
    "layers": '[["DDc","plugin=jerasure technique=cauchy_good"]]'}

PROFILES = {
    "lrc_k8m4l4": ("lrc", {"k": 8, "m": 4, "l": 4}),
    "lrc_k4m2l3": ("lrc", {"k": 4, "m": 2, "l": 3}),
    "shec_k4m3c2": ("shec", {"k": 4, "m": 3, "c": 2}),
    "shec_k8m4c3": ("shec", {"k": 8, "m": 4, "c": 3}),
    "shec_k6m3c2": ("shec", {"k": 6, "m": 3, "c": 2}),
    "lrc_layered": ("lrc", LAYERED),
    "lrc_layer_override": ("lrc", OVERRIDE),
}


def _pair(plugin, profile):
    prof = {k: str(v) for k, v in profile.items()}
    return (ErasureCodePluginRegistry.instance().factory(plugin, dict(prof)),
            JaxRegistry.instance().factory(plugin, dict(prof)))


def _payload(codec, seed, per_chunk=192):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, codec.get_data_chunk_count() * per_chunk,
                        dtype=np.uint8).tobytes()


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_geometry_and_mapping_match_jax(name):
    port, jax = _pair(*PROFILES[name])
    assert type(port).__name__ == type(jax).__name__
    assert isinstance(port, (ec_lrc.ErasureCodeLrc, ec_lrc.ErasureCodeLrcLayered,
                             ec_shec.ErasureCodeShec))
    assert port.get_chunk_count() == jax.get_chunk_count()
    assert port.get_data_chunk_count() == jax.get_data_chunk_count()
    assert port.get_coding_chunk_count() == jax.get_coding_chunk_count()
    assert port.get_chunk_mapping() == jax.get_chunk_mapping()
    n = port.get_chunk_count()
    assert [port.chunk_index(i) for i in range(n)] == \
        [jax.chunk_index(i) for i in range(n)]
    for width in (1, 4096, 12345):
        assert port.get_chunk_size(width) == jax.get_chunk_size(width)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_and_every_single_and_double_erasure_match_jax(name):
    port, jax = _pair(*PROFILES[name])
    n = port.get_chunk_count()
    payload = _payload(port, len(name))
    enc = port.encode(set(range(n)), payload)
    ref = jax.encode(set(range(n)), payload)
    for i in range(n):
        np.testing.assert_array_equal(enc[i], ref[i], err_msg=f"chunk {i}")
    full = np.stack([np.asarray(enc[i]) for i in range(n)])
    cs = full.shape[1]
    decoded = 0
    for erased in itertools.chain(itertools.combinations(range(n), 1),
                                  itertools.combinations(range(n), 2)):
        dense = full.copy()
        dense[list(erased)] = 0
        got = np.asarray(port.decode_chunks(dense, list(erased)))
        want = np.asarray(jax.decode_chunks(dense, list(erased)))
        np.testing.assert_array_equal(got, want, err_msg=f"{erased}")
        assert getattr(port, "_unsolved", set()) == \
            getattr(jax, "_unsolved", set()), erased
        avail = {i: enc[i] for i in range(n) if i not in erased}
        try:
            ref_dec = jax.decode(set(range(n)), avail, cs)
        except JaxError as e:
            with pytest.raises(ErasureCodeError) as got_err:
                port.decode(set(range(n)), avail, cs)
            assert got_err.value.errno == e.errno
            continue
        dec = port.decode(set(range(n)), avail, cs)
        for i in range(n):
            np.testing.assert_array_equal(dec[i], ref_dec[i])
            np.testing.assert_array_equal(dec[i], full[i])
        decoded += 1
    assert decoded >= n      # every single erasure at least


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_minimum_to_decode_matches_jax(name):
    port, jax = _pair(*PROFILES[name])
    n = port.get_chunk_count()
    for want in [{e} for e in range(n)] + [{0, 1}, set(range(2))]:
        for gone in [set(want), {n - 1}, {0, n - 1}]:
            avail = set(range(n)) - gone
            try:
                ref = jax.minimum_to_decode(want, avail)
            except JaxError as e:
                with pytest.raises(ErasureCodeError) as got_err:
                    port.minimum_to_decode(want, avail)
                assert got_err.value.errno == e.errno
                continue
            assert port.minimum_to_decode(want, avail) == ref
            assert port.minimum_to_decode_with_cost(want, avail) == \
                jax.minimum_to_decode_with_cost(want, avail)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_minimum_to_decode_is_sufficient(name):
    """Whatever minimum_to_decode returns for one lost chunk decodes it,
    and fewer than k chunks serve a local repair where the reference's
    do (the property LRC and SHEC exist for)."""
    port, jax = _pair(*PROFILES[name])
    n = port.get_chunk_count()
    payload = _payload(port, 3)
    enc = port.encode(set(range(n)), payload)
    cs = len(enc[0])
    for e in range(n):
        need = port.minimum_to_decode({e}, set(range(n)) - {e})
        dec = port.decode({e}, {i: enc[i] for i in need}, cs)
        np.testing.assert_array_equal(dec[e], enc[e])
        assert (len(need) < port.get_data_chunk_count()) == \
            (len(jax.minimum_to_decode({e}, set(range(n)) - {e}))
             < jax.get_data_chunk_count())


def test_shec_k8_m4_c3_triple_erasures_sampled():
    port, jax = _pair("shec", {"k": 8, "m": 4, "c": 3})
    n = port.get_chunk_count()
    rng = np.random.default_rng(2)
    enc = port.encode(set(range(n)), _payload(port, 2, 128))
    full = np.stack([np.asarray(enc[i]) for i in range(n)])
    combos = list(itertools.combinations(range(n), 3))
    for i in rng.choice(len(combos), 40, replace=False):
        erased = list(combos[i])
        dense = full.copy()
        dense[erased] = 0
        got = np.asarray(port.decode_chunks(dense, erased))
        np.testing.assert_array_equal(got, np.asarray(
            jax.decode_chunks(dense, erased)))
        np.testing.assert_array_equal(got, full, err_msg=f"{erased}")


@pytest.mark.parametrize("plugin,profile", [
    ("lrc", {"k": "5", "m": "2", "l": "3"}),        # 7 % 3 != 0
    ("lrc", {"k": "4", "m": "2", "l": "1"}),
    ("shec", {"k": "4", "m": "2", "c": "3"}),        # c > m
    ("lrc", {"plugin": "lrc", "layers": '[["cDD",""]]'}),
    ("lrc", {"plugin": "lrc", "mapping": "_DD",
             "layers": '[["cDDDD",""]]'}),
    ("lrc", {"plugin": "lrc", "mapping": "_DD_",
             "layers": '[["cD_D",""]]'}),
    ("lrc", {"plugin": "lrc", "mapping": "_DD",
             "layers": '[["cDc",""]]'}),
    ("lrc", {"plugin": "lrc", "mapping": "_DD", "layers": "[not json"}),
], ids=["lrc_indivisible", "lrc_l1", "shec_c_over_m", "layered_no_mapping",
        "layered_length", "layered_consumes", "layered_clobbers",
        "layered_bad_json"])
def test_bad_profiles_raise_like_jax(plugin, profile):
    with pytest.raises(JaxError) as ref:
        JaxRegistry.instance().factory(plugin, dict(profile))
    with pytest.raises(ErasureCodeError) as got:
        ErasureCodePluginRegistry.instance().factory(plugin, dict(profile))
    assert got.value.errno == ref.value.errno
    assert str(got.value) == str(ref.value)

"""Plugin `torch` (device="cpu": the kernels' plain versions) against
ceph_tpu's plugin `jax`, and the pinned jax encode corpus reproduced
through the state-carrying conversion.  Exact equality throughout."""

import hashlib
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu.ec import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch.ec import ErasureCodePluginRegistry as TorchRegistry
from ceph_tpu_torch.ec.plugins.ec_torch import from_jax_state

CORPUS = Path(__file__).parent / "corpus" / "encode_corpus.json"
PROFILES = [(4, 2, "cauchy"), (8, 3, "cauchy"), (4, 2, "reed_sol_van"),
            (2, 1, "cauchy")]


def _pair(k, m, technique):
    prof = {"k": str(k), "m": str(m), "technique": technique}
    jax_codec = JaxRegistry.instance().factory("jax", dict(prof))
    torch_codec = TorchRegistry.instance().factory(
        "torch", dict(prof, device="cpu"))
    return jax_codec, torch_codec


@pytest.mark.parametrize("k,m,technique", PROFILES)
def test_encode_chunks_matches_jax(k, m, technique):
    jc, tc = _pair(k, m, technique)
    np.testing.assert_array_equal(tc.matrix, jc.matrix)
    rng = np.random.default_rng(k * 100 + m)
    for n in (64, 4096, 4096 + 64 * 3):
        chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
        np.testing.assert_array_equal(tc.encode_chunks(chunks),
                                      jc.encode_chunks(chunks))


@pytest.mark.parametrize("k,m,technique", PROFILES)
def test_decode_chunks_every_erasure_set(k, m, technique):
    jc, tc = _pair(k, m, technique)
    rng = np.random.default_rng(k * 10 + m + 1)
    n = 512
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    allsh = np.concatenate([data, tc.encode_chunks(data)])
    for e in range(1, m + 1):
        for lost in itertools.combinations(range(k + m), e):
            dense = allsh.copy()
            dense[list(lost)] = 0
            got = tc.decode_chunks(dense, list(lost))
            np.testing.assert_array_equal(
                got, jc.decode_chunks(dense, list(lost)))
            np.testing.assert_array_equal(got, allsh)


@pytest.mark.parametrize("k,m,technique", PROFILES[:3])
def test_encode_chunks_with_crc_matches_jax(k, m, technique):
    jc, tc = _pair(k, m, technique)
    rng = np.random.default_rng(k + m + 50)
    for n in (2048, 5000, 2048 * 3 + 64):
        chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
        seeds = [int(x) for x in rng.integers(0, 2 ** 32, k + m)]
        tp, tcrcs = tc.encode_chunks_with_crc(chunks, seeds)
        jp, jcrcs = jc.encode_chunks_with_crc(chunks, seeds)
        np.testing.assert_array_equal(tp, jp)
        assert tcrcs == jcrcs


def test_codec_geometry_and_signature():
    jc, tc = _pair(8, 3, "cauchy")
    assert tc.get_chunk_size(4096 * 8) == jc.get_chunk_size(4096 * 8)
    assert tc.get_alignment() == jc.get_alignment() == 64
    sig = tc.codec_signature()
    assert sig[0] == "torch" and sig[1:] == jc.codec_signature()[1:]


@pytest.mark.parametrize("k,m", [(4, 2), (2, 1)])
def test_pinned_jax_corpus_through_state_conversion(k, m):
    """The jax corpus digests (tests/test_corpus.py) reproduced by a
    torch codec built from the jax codec's state — both sides encode
    with the same generator matrix and decode plans."""
    prof = {"k": str(k), "m": str(m), "technique": "cauchy"}
    jc = JaxRegistry.instance().factory("jax", dict(prof))
    lost = (0, k) if m > 1 else (1,)
    survivors = tuple(s for s in range(k + m) if s not in lost)[:k]
    jc._decode_plan(survivors, lost)
    tc = from_jax_state(jc, device="cpu")
    np.testing.assert_array_equal(tc.matrix, jc.matrix)
    assert set(tc._decode_cache) == {(survivors, lost)}
    np.testing.assert_array_equal(tc._decode_cache[(survivors, lost)][0],
                                  jc._decode_plan(survivors, lost)[0])
    rng = np.random.default_rng(0xC0FFEE)
    data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    want = tc.get_chunk_size(len(data)) * tc.get_data_chunk_count()
    padded = np.frombuffer(data.ljust(want, b"\x00"), dtype=np.uint8)
    chunks = tc.encode(set(range(tc.get_chunk_count())), padded)
    got = {str(s): hashlib.sha256(np.asarray(c).tobytes()).hexdigest()
           for s, c in sorted(chunks.items())}
    corpus = json.loads(CORPUS.read_text())
    assert got == corpus[f"jax/k={k},m={m},technique=cauchy"]

"""The port's plugins against the pinned encode corpus.

tests/corpus/encode_corpus.json (read only here) holds sha256 digests of
every chunk that ceph_tpu's plugins encode from a fixed payload
(tests/test_corpus.py).  The port's CPU plugins must give the digests of
their namesakes, and the torch plugin on device="cpu" those of ceph_tpu's
jax plugin with the same Cauchy matrix: a kernel or table change in the
port can never silently change what is on disk.  Payload and padding
are those of tests/test_corpus.py:53-67.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from ceph_tpu_torch.ec import ErasureCodePluginRegistry

CORPUS = Path(__file__).parent / "corpus" / "encode_corpus.json"
PAYLOAD_LEN = 4096

# (the port's plugin, its profile, the corpus case it must match)
CASES = [
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"}, None),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_good"}, None),
    ("jerasure", {"k": "6", "m": "3", "technique": "reed_sol_van"}, None),
    ("jerasure", {"k": "4", "m": "2", "technique": "liberation",
                  "w": "7"}, None),
    ("jerasure", {"k": "4", "m": "2", "technique": "blaum_roth",
                  "w": "6"}, None),
    ("jerasure", {"k": "4", "m": "2", "technique": "liber8tion"}, None),
    ("isa", {"k": "4", "m": "2"}, None),
    ("example", {}, None),
    ("torch", {"k": "4", "m": "2", "technique": "cauchy"},
     "jax/k=4,m=2,technique=cauchy"),
    ("torch", {"k": "2", "m": "1", "technique": "cauchy"},
     "jax/k=2,m=1,technique=cauchy"),
]


def _case_id(plugin: str, profile: dict) -> str:
    return plugin + "/" + ",".join(f"{k}={v}"
                                   for k, v in sorted(profile.items()))


def _payload() -> bytes:
    rng = np.random.default_rng(0xC0FFEE)
    return rng.integers(0, 256, PAYLOAD_LEN, dtype=np.uint8).tobytes()


def _encode_digests(plugin: str, profile: dict) -> dict:
    codec = ErasureCodePluginRegistry.instance().factory(plugin,
                                                        dict(profile))
    data = _payload()
    want = codec.get_chunk_size(len(data)) * codec.get_data_chunk_count()
    padded = np.frombuffer(data.ljust(want, b"\x00"), dtype=np.uint8)
    chunks = codec.encode(set(range(codec.get_chunk_count())), padded)
    return {str(s): hashlib.sha256(np.asarray(c).tobytes()).hexdigest()
            for s, c in sorted(chunks.items())}


@pytest.mark.parametrize("plugin,profile,case", CASES,
                         ids=[_case_id(p, prof) for p, prof, _ in CASES])
def test_port_encode_bytes_pinned(plugin, profile, case):
    corpus = json.loads(CORPUS.read_text())
    cid = case or _case_id(plugin, profile)
    if plugin == "torch":
        profile = dict(profile, device="cpu")
    assert _encode_digests(plugin, profile) == corpus[cid], (
        f"the port's {plugin} plugin no longer gives the pinned parity "
        f"bytes of {cid}")

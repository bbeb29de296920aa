"""The layered LRC plugin's device path (ceph_tpu_torch/ec/plugins/
ec_lrc.ErasureCodeLrcLayeredDevice) on Ceph's documented k=4 m=2 l=3
profile: its composed generator against the benchmark's plain layered
reference, every single-chunk repair and every two-chunk loss against
the reference and the host layered path, and the fused write path's
parity and crcs against the host path's bytes and crc32c.

The CPU cases run the plain versions (`device="cpu"`) at small widths,
seeded.  The cases marked `cuda` run the cell's 1 MiB chunks on the
card, one K1 launch a repair, against the same reference; they skip
without a card.  This file imports nothing of JAX or ceph_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_lrc_device.py -q
"""

import itertools
import json

import numpy as np
import pytest
import torch

from benchmark.reference import lrc as ref_lrc
from ceph_tpu_torch.common import crc32c as crc
from ceph_tpu_torch.ec import ErasureCodeError, ErasureCodePluginRegistry
from ceph_tpu_torch.ec.plugins import ec_lrc
from ceph_tpu_torch.ops import bitsliced as bs

MAPPING = "__DD__DD"
LAYERS = [["_cDD_cDD", ""], ["cDDD____", ""], ["____cDDD", ""]]
N, K = 8, 4


def _codec(device=None, layers=LAYERS, mapping=MAPPING):
    prof = {"mapping": mapping, "layers": json.dumps(layers)}
    if device is not None:
        prof["device"] = str(device)
    return ErasureCodePluginRegistry.instance().factory("lrc", prof)


@pytest.fixture(scope="module")
def ref():
    return ref_lrc.Layered(MAPPING, LAYERS)


@pytest.fixture(scope="module")
def order(ref):
    return ref.logical_order()


def _full(ref, order, width, seed):
    """(data (k, width), every chunk (n, width) in logical order)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (K, width), dtype=np.uint8)
    full = ref.encode(torch.from_numpy(data))[order].numpy()
    return data, full


@pytest.fixture(autouse=True)
def fresh_counts():
    ec_lrc.reset_local_repair_counts()
    yield
    ec_lrc.reset_local_repair_counts()


def test_layers_and_mapping(order):
    dev = _codec("cpu")
    assert isinstance(dev, ec_lrc.ErasureCodeLrcLayeredDevice)
    assert type(_codec()) is ec_lrc.ErasureCodeLrcLayered
    assert dev.get_chunk_mapping() == order == [2, 3, 6, 7, 0, 1, 4, 5]
    mats = [lay.codec.matrix[lay.codec.k:].tolist() for lay in dev.layers]
    assert mats == [[[27, 28, 18, 20], [28, 27, 20, 18]], [[1, 1, 1]],
                    [[1, 1, 1]]]


def test_generator_is_the_layered_encode(ref, order):
    """Column j of the generator is the code of the j-th unit data
    chunk, layer by layer (the reference, in logical order)."""
    dev = _codec("cpu")
    unit = torch.eye(K, dtype=torch.uint8)
    want = ref.encode(unit)[order].numpy()
    np.testing.assert_array_equal(dev.generator, want)
    np.testing.assert_array_equal(dev.generator[:K], np.eye(K))


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_encode_matches_host_and_reference(ref, order, seed):
    data, full = _full(ref, order, 4096 + 64, seed)
    host, dev = _codec(), _codec("cpu")
    np.testing.assert_array_equal(np.asarray(host.encode_chunks(data)),
                                  full[K:])
    np.testing.assert_array_equal(dev.encode_chunks(data), full[K:])


@pytest.mark.parametrize("lost", range(N))
def test_single_chunk_repair(ref, order, lost):
    """Every lost chunk is rebuilt from the 3 other chunks of its local
    group, one plan apply, equal to the reference and to the host
    layered decode from the same helpers."""
    _, full = _full(ref, order, 8192, 10 + lost)
    host, dev = _codec(), _codec("cpu")
    avail = [c for c in range(N) if c != lost]
    helpers = tuple(sorted(dev.minimum_to_decode([lost], avail)))
    assert helpers == tuple(sorted(host.minimum_to_decode([lost], avail)))
    assert helpers == tuple(sorted(order.index(p) for p in
                                   ref.local_group(order[lost])))
    out = dev.decode_chunks_device(torch.from_numpy(full[list(helpers)]),
                                   helpers, (lost,))
    assert out.shape == (1, 8192)
    np.testing.assert_array_equal(out.numpy()[0], full[lost])
    dense = np.zeros_like(full)
    dense[list(helpers)] = full[list(helpers)]
    erased = [c for c in range(N) if c not in helpers]
    np.testing.assert_array_equal(host.decode_chunks(dense, erased)[lost],
                                  full[lost])
    assert ec_lrc.local_repair_counts() == {
        "helper_rows": 3, "rebuilt_rows": 1, "plans_built": 1,
        "plan_hits": 0}
    dev.decode_chunks_device(torch.from_numpy(full[list(helpers)]),
                             helpers, (lost,))
    assert ec_lrc.local_repair_counts()["plan_hits"] == 1


@pytest.mark.parametrize("pair", list(itertools.combinations(range(N), 2)))
def test_two_chunk_loss(ref, order, pair):
    """All 28 two-chunk losses: the device path's decode_chunks equals
    the host layered decode byte for byte (rows and unsolved set), and
    decode_chunks_device from the six survivors equals the reference."""
    _, full = _full(ref, order, 4096, 100 + sum(pair))
    host, dev = _codec(), _codec("cpu")
    dense = full.copy()
    dense[list(pair)] = 0
    got = dev.decode_chunks(dense, list(pair))
    np.testing.assert_array_equal(got, host.decode_chunks(dense, list(pair)))
    np.testing.assert_array_equal(got, full)
    assert dev._unsolved == host._unsolved == set()
    surv = tuple(c for c in range(N) if c not in pair)
    out = dev.decode_chunks_device(torch.from_numpy(full[list(surv)]),
                                   surv, pair)
    np.testing.assert_array_equal(out.numpy(), full[list(pair)])


def test_unsolvable_losses(ref, order):
    """Three chunks of one local group lost with the global layer short
    too: the device path leaves the rows the host path leaves, decode()
    raises EIO on both, and a device repair of them raises."""
    _, full = _full(ref, order, 1024, 7)
    host, dev = _codec(), _codec("cpu")
    lost = [0, 1, 4, 5]            # positions 2, 3, 0, 1: group one whole
    chunks = {c: full[c] for c in range(N) if c not in lost}
    for codec in (host, dev):
        with pytest.raises(ErasureCodeError) as err:
            codec.decode({0}, chunks, 1024)
        assert err.value.errno == 5
    assert dev._unsolved == host._unsolved
    surv = tuple(c for c in range(N) if c not in lost)
    with pytest.raises(ErasureCodeError):
        dev.decode_chunks_device(torch.from_numpy(full[list(surv)]), surv,
                                 (0,))


SEEDS = [0xFFFFFFFF] * N, [0x1234567 * (c + 1) & 0xFFFFFFFF
                           for c in range(N)]


def _fused(codec, data, seeds):
    """The write path's fused launch through its submit halves: (parity,
    the crc32c of each of the 8 chunks from `seeds`)."""
    [(parity, l, tail, body)] = codec.encode_extents_with_crc_finalize(
        codec.encode_extents_with_crc_submit([data]))
    return np.asarray(parity), codec.fold_extent_crcs(l, tail, seeds, body)


@pytest.mark.parametrize("width", [4096, 6144 + 40])
def test_fused_encode_crcs(ref, order, width):
    """The write path's fused launch on the generator: parity equal to
    the host path's bytes, and a crc32c of each of the 8 chunks equal to
    the host crc32c of that chunk, seeded as HashInfo is and otherwise;
    the plain parity's submit halves give the same parity."""
    data, full = _full(ref, order, width, width)
    host, dev = _codec(), _codec("cpu")
    for seeds in SEEDS:
        parity, crcs = _fused(dev, data, seeds)
        np.testing.assert_array_equal(parity,
                                      np.asarray(host.encode_chunks(data)))
        np.testing.assert_array_equal(parity, full[K:])
        assert crcs == [crc.crc32c(full[c].tobytes(), seeds[c])
                        for c in range(N)]
    np.testing.assert_array_equal(
        dev.encode_chunks_finalize(dev.encode_chunks_submit(data)), full[K:])


def test_wide_plan_takes_k4(monkeypatch):
    """A plan whose product tables exceed K1's shared memory (32 targets
    from 32 helpers of a k=32 m=32 layer) is applied by K4, equal to the
    host layered decode."""
    mapping = "D" * 32 + "_" * 32
    dev = _codec("cpu", layers=[["D" * 32 + "c" * 32, ""]], mapping=mapping)
    host = _codec(layers=[["D" * 32 + "c" * 32, ""]], mapping=mapping)
    calls = []
    real = bs.gf_bitmatmul_stream
    monkeypatch.setattr(bs, "gf_bitmatmul_stream",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(32)
    data = rng.integers(0, 256, (32, 512), dtype=np.uint8)
    full = np.concatenate([data, np.asarray(host.encode_chunks(data))])
    helpers = tuple(range(16, 48))
    targets = tuple(c for c in range(64) if c not in helpers)
    assert not bs.k1_tables_fit(len(targets), len(helpers))
    out = dev.decode_chunks_device(torch.from_numpy(full[list(helpers)]),
                                   helpers, targets)
    np.testing.assert_array_equal(out.numpy(), full[list(targets)])
    assert calls == [1]


def test_plan_span_only_under_the_profiler(ref, order):
    """A plan composed under torch.profiler is one `ec.lrc.plan` span; a
    cached plan, or one composed with the profiler off, is none."""
    _, full = _full(ref, order, 1024, 3)
    dev = _codec("cpu")
    rows = torch.from_numpy(full[[1, 4, 5]])
    dev.decode_chunks_device(rows, (1, 4, 5), (0,))          # off: no span
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dev.decode_chunks_device(rows, (1, 4, 5), (0,))      # a hit
        rows2 = torch.from_numpy(full[[0, 4, 5]])
        dev.decode_chunks_device(rows2, (0, 4, 5), (1,))     # a miss
    spans = [e for e in prof.events() if e.name == "ec.lrc.plan"]
    assert len(spans) == 1
    assert ec_lrc.local_repair_counts()["plans_built"] == 2
    assert ec_lrc.local_repair_counts()["plan_hits"] == 1


def test_codec_signature():
    """Equal grammars coalesce; the torch plugin with the same generator
    does not, nor does another grammar."""
    a, b = _codec("cpu"), _codec("cpu")
    assert a.codec_signature() == b.codec_signature()
    torch_codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "4", "m": "4", "device": "cpu"})
    torch_codec.set_matrix(a.generator)
    assert torch_codec.codec_signature() != a.codec_signature()
    other = _codec("cpu", layers=[["_cDD_cDD", ""], ["cDDD____", ""],
                                  ["____cDDD", "technique=cauchy_good"]])
    assert other.codec_signature() != a.codec_signature()


def test_refusals():
    """A layer without a generator matrix (a minimal-density technique)
    is refused where a device is asked for, and so is the k/m/l form;
    without a device both build on the host as before."""
    layers = [["DDDD_c_c", "technique=liberation"], ["____cD__", ""],
              ["______cD", ""]]
    mapping = "DDDD____"
    _codec(layers=layers, mapping=mapping)
    with pytest.raises(ErasureCodeError, match="generator matrix"):
        _codec("cpu", layers=layers, mapping=mapping)
    prof = {"k": "4", "m": "2", "l": "3"}
    assert type(ErasureCodePluginRegistry.instance().factory(
        "lrc", dict(prof))) is ec_lrc.ErasureCodeLrc
    with pytest.raises(ErasureCodeError, match="layered"):
        ErasureCodePluginRegistry.instance().factory(
            "lrc", dict(prof, device="cpu"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda_device(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE", "0")     # the static point
    from ceph_tpu_torch import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
def test_repairs_on_the_card(cuda_device, ref, order):
    """The cell's 1 MiB chunks: every one of the 8 lost chunks rebuilt
    from its local group in one K1 launch, equal to the reference; under
    the profiler the launch's prep opens at the entry."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(2**31 + 9)
    data = torch.randint(0, 256, (K, 1 << 20), dtype=torch.uint8,
                         device=cuda_device, generator=gen)
    full = ref.encode(data)[order]
    dev = _codec(cuda_device)
    for lost in range(N):
        helpers = tuple(sorted(dev.minimum_to_decode(
            [lost], [c for c in range(N) if c != lost])))
        rows = full[list(helpers)].contiguous()
        dev.decode_chunks_device(rows, helpers, (lost,))
        torch.cuda.synchronize()
        before = bs.launch_counts()["gf_bitmatmul"]
        out = dev.decode_chunks_device(rows, helpers, (lost,))
        torch.cuda.synchronize()
        assert bs.launch_counts()["gf_bitmatmul"] == before + 1
        assert torch.equal(out[0], full[lost]), lost
    stages0 = bs.launch_stages()["gf_bitmatmul"]["calls"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        dev.decode_chunks_device(rows, helpers, (lost,))
        torch.cuda.synchronize()
    assert bs.launch_stages()["gf_bitmatmul"]["calls"] == stages0 + 1
    counts = ec_lrc.local_repair_counts()
    assert counts["helper_rows"] == 3 * counts["rebuilt_rows"] == 3 * 17


@pytest.mark.cuda
def test_fused_encode_on_the_card(cuda_device, ref, order):
    """The fused write path on the card (K3 at the card's operating
    point): parity and the 8 crcs equal to the CPU device path's and to
    the host crc32c, at one 1 MiB chunk a shard."""
    rng = np.random.default_rng(2**31 + 13)
    data = rng.integers(0, 256, (K, 1 << 20), dtype=np.uint8)
    full = ref.encode(torch.from_numpy(data))[order].numpy()
    parity, crcs = _fused(_codec(cuda_device), data, SEEDS[1])
    np.testing.assert_array_equal(parity, full[K:])
    assert crcs == [crc.crc32c(full[c].tobytes(), SEEDS[1][c])
                    for c in range(N)]
    assert crcs == _fused(_codec("cpu"), data, SEEDS[1])[1]

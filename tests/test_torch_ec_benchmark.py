"""The plugin's device-resident entries (the contract of Pallas kernel
#5, served by K1) against ErasureCodeJax's on the CPU, and the port's
ec_benchmark CLI (-p torch -P device=cpu, and its CPU plugins): output
contract, --batch, exhaustive decode, --ab, the default plugin, and its
errors."""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceph_tpu.ec as jec
from ceph_tpu_torch.ec import ErasureCodePluginRegistry
from ceph_tpu_torch.tools import ec_benchmark

LINE = re.compile(r"^\d+\.\d{6}\t(\d+)$")


def _codecs(k, m):
    jax_codec = jec.ErasureCodePluginRegistry.instance().factory(
        "jax", {"k": str(k), "m": str(m)})
    torch_codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": str(k), "m": str(m), "device": "cpu"})
    return jax_codec, torch_codec


@pytest.mark.parametrize("n", [4096, 1000, 131])
def test_encode_chunks_device_matches_jax(n):
    jc, tc = _codecs(8, 3)
    chunks = np.random.default_rng(n).integers(0, 256, (8, n), dtype=np.uint8)
    want = np.asarray(jc.encode_chunks_device(jnp.asarray(chunks)))
    got = tc.encode_chunks_device(torch.from_numpy(chunks))
    assert got.dtype == torch.uint8 and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,c", [(4, 1024), (3, 1000)])
def test_encode_stripes_matches_jax(b, c):
    jc, tc = _codecs(4, 2)
    stripes = np.random.default_rng(b * c).integers(0, 256, (b, 4, c),
                                                   dtype=np.uint8)
    want = np.asarray(jc.encode_stripes(jnp.asarray(stripes)))
    got = tc.encode_stripes(torch.from_numpy(stripes))
    assert got.shape == (b, 2, c)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(b):                 # one stripe at a time agrees too
        np.testing.assert_array_equal(
            got[i].numpy(),
            tc.encode_chunks_device(torch.from_numpy(stripes[i])).numpy())
    with pytest.raises(ValueError, match="k=3"):
        tc.encode_stripes(torch.zeros((2, 3, 64), dtype=torch.uint8))


@pytest.mark.parametrize("targets", [(0,), (1, 6), (2, 9, 10)])
def test_decode_chunks_device_matches_jax(targets):
    jc, tc = _codecs(8, 3)
    rng = np.random.default_rng(sum(targets))
    n = 1000
    data = rng.integers(0, 256, (8, n), dtype=np.uint8)
    allsh = np.concatenate([data, jc.encode_chunks(data)])
    survivors = tuple(s for s in range(11) if s not in targets)[:8]
    avail = np.ascontiguousarray(allsh[list(survivors)])
    want = np.asarray(jc.decode_chunks_device(jnp.asarray(avail), survivors,
                                              targets))
    got = tc.decode_chunks_device(torch.from_numpy(avail), survivors, targets)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), allsh[list(targets)])


@pytest.mark.parametrize("combine", ["xla", "kernel"])
def test_encode_words_with_crc_matches_host(monkeypatch, combine):
    """The device-resident fused entry against ErasureCodeJax's
    encode_words_with_crc at the same operating point (its Pallas
    kernels in interpret mode), at both combines: equal parity and one
    equal L per shard over the whole width, which folds to the host
    crc32c of every shard."""
    import functools

    from ceph_tpu.ops import bitsliced as jbs
    from ceph_tpu.ops import crc32c_linear as jcl
    from ceph_tpu_torch.common import crc32c
    from ceph_tpu_torch.ops import crc32c_linear as cl
    jc, tc = _codecs(4, 2)
    point = {"tile": 4096, "wb": 256, "extract": "planar",
             "combine": combine}
    # the JAX entry runs its w32 kernels only off the CPU; on the CPU
    # they run in interpret mode, as ceph_tpu's own tests run them
    jc._use_w32 = True
    jc._enc_bitmat32 = jnp.asarray(jbs._w32_bitmat(jc.matrix[4:]),
                                   dtype=jnp.int8)
    monkeypatch.setattr(jbs, "gf_encode_with_crc_w32_fold", functools.partial(
        jbs.gf_encode_with_crc_w32_fold, interpret=True))
    jc._fused_point = dict(point)
    tc._fused_point = dict(point)
    n = 4096 * 3
    chunks = np.random.default_rng(3).integers(0, 256, (4, n),
                                               dtype=np.uint8)
    par_w, lbits = jc.encode_words_with_crc(
        jnp.asarray(chunks.view("<u4").view(np.int32)))
    want_par = np.asarray(par_w).view("<u4").view(np.uint8).reshape(2, n)
    want_l = jcl.bits_to_u32(np.asarray(lbits)).astype(np.int64)
    par, l = tc.encode_words_with_crc(torch.from_numpy(chunks))
    np.testing.assert_array_equal(par.numpy(), want_par)
    np.testing.assert_array_equal(l.numpy(), want_l)
    allsh = np.concatenate([chunks, want_par])
    for s in range(6):
        assert cl.fold_run_crc(int(l[s]), n, 0xFFFFFFFF) == \
            crc32c.crc32c(allsh[s].tobytes())


def _run(capsys, *argv):
    rc = ec_benchmark.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("extra,kib", [
    ((), 5 * 64),
    (("--batch", "4"), 8 * 64),            # 8 // 4 = 2 calls of 4 stripes
    (("--batch", "16"), 16 * 64),          # at least one call
])
def test_cli_encode_output_contract(capsys, extra, kib):
    iters = "8" if extra else "5"
    rc, out, err = _run(capsys, "-p", "torch", "-P", "k=8", "-P", "m=3",
                        "-P", "device=cpu", "-S", "65536", "-i", iters,
                        "--gbps", *extra)
    assert rc == 0
    (line,) = out.strip().splitlines()
    assert int(LINE.match(line).group(1)) == kib
    assert re.match(r"^# \d+\.\d{3} GB/s$", err.strip())


def test_cli_decode_exhaustive_verifies_every_pair(capsys, monkeypatch):
    """-E exhaustive decodes and byte-checks all C(n, e) erasure sets
    before timing, through the host decode and the device entry; the
    timed calls go through the device entry."""
    from ceph_tpu_torch.ec.plugins import ec_torch
    seen, seen_dev = [], []
    real = ec_torch.ErasureCodeTorch.decode_chunks
    real_dev = ec_torch.ErasureCodeTorch.decode_chunks_device

    def spy(self, dense, erasures):
        seen.append(tuple(sorted(erasures)))
        return real(self, dense, erasures)

    def spy_dev(self, chunks, survivors, targets):
        seen_dev.append(tuple(targets))
        return real_dev(self, chunks, survivors, targets)
    monkeypatch.setattr(ec_torch.ErasureCodeTorch, "decode_chunks", spy)
    monkeypatch.setattr(ec_torch.ErasureCodeTorch, "decode_chunks_device",
                        spy_dev)
    rc, out, _ = _run(capsys, "-p", "torch", "-P", "k=4", "-P", "m=2",
                      "-P", "device=cpu", "-S", "8192", "-i", "3",
                      "-w", "decode", "-e", "2", "-E", "exhaustive")
    assert rc == 0
    assert int(LINE.match(out.strip()).group(1)) == 3 * 8
    assert len(set(seen)) == 15            # C(6, 2)
    assert len(set(seen_dev)) == 15 and len(seen_dev) == 15 + 3


def test_cli_decode_named_erasures_and_errors(capsys, monkeypatch):
    rc, out, _ = _run(capsys, "-p", "torch", "-P", "k=4", "-P", "m=2",
                      "-P", "device=cpu", "-S", "4096", "-i", "2",
                      "-w", "decode", "-N", "1", "-N", "4")
    assert rc == 0 and LINE.match(out.strip())
    rc, _, err = _run(capsys, "-p", "torch", "-P", "k=4", "-P", "m=2",
                      "-P", "device=cpu", "-w", "decode", "-e", "3")
    assert rc == 1 and "cannot decode" in err
    rc, _, err = _run(capsys, "-p", "nosuch", "-P", "device=cpu")
    assert rc == 1 and "ec_benchmark:" in err
    # --ab's torch side runs on the card unless -P device=cpu
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(capsys, "--ab", "-P", "k=4", "-P", "m=2")
    assert rc == 1 and not out and "no CUDA device" in err
    with pytest.raises(SystemExit):
        ec_benchmark.main(["-P", "k8"])


def test_cli_needs_a_card_by_default(capsys, monkeypatch):
    """-p torch without -P device runs on the card, so without one it
    fails with a clean error; the CPU plugins need none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(capsys, "-p", "torch", "-P", "k=4", "-P", "m=2")
    assert rc == 1 and not out and "no CUDA device" in err


def test_cli_default_plugin_is_jerasure(capsys, monkeypatch):
    """-p left unset runs the reference's default, jerasure, through
    the host loop of N encode_chunks calls."""
    seen = []
    real = ec_benchmark.make_codec

    def spy(plugin, parameters):
        seen.append(plugin)
        return real(plugin, parameters)
    monkeypatch.setattr(ec_benchmark, "make_codec", spy)
    rc, out, _ = _run(capsys, "-P", "k=4", "-P", "m=2", "-S", "65536",
                      "-i", "7")
    assert rc == 0 and seen == ["jerasure"]
    assert int(LINE.match(out.strip()).group(1)) == 7 * 64


@pytest.mark.parametrize("plugin", ["isa", "jerasure", "example"])
def test_cli_cpu_plugins_encode_and_decode(capsys, plugin):
    profile = ["-P", "k=4", "-P", "m=2"] if plugin != "example" else []
    rc, out, _ = _run(capsys, "-p", plugin, *profile, "-S", "32768",
                      "-i", "3")
    assert rc == 0 and int(LINE.match(out.strip()).group(1)) == 3 * 32
    rc, out, _ = _run(capsys, "-p", plugin, *profile, "-S", "32768",
                      "-i", "3", "-w", "decode", "-e", "1",
                      "-E", "exhaustive")
    assert rc == 0 and int(LINE.match(out.strip()).group(1)) == 3 * 32


def test_cli_ab_rows(capsys):
    """--ab on the CPU (-P device=cpu for the torch side): isa against
    torch, per call and batched, one JSON row each, then the two
    torch_over_cpu ratio rows (ceph_tpu's key is jax_over_cpu)."""
    rc, out, _ = _run(capsys, "--ab", "-P", "k=4", "-P", "m=2",
                      "-P", "device=cpu", "-S", "16384", "--batch", "4",
                      "--min-time", "0.01")
    assert rc == 0
    rows = [json.loads(line) for line in out.strip().splitlines()]
    sides = [r for r in rows if "side" in r]
    assert [(r["side"], r["mode"]) for r in sides] == [
        ("isa", "per_call"), ("torch", "per_call"),
        ("isa", "batched"), ("torch", "batched")]
    for r in sides:
        assert set(r) == {"side", "mode", "bytes_per_iter", "iters", "gbps"}
        assert r["iters"] >= 5 and r["gbps"] >= 0     # rounded to 1 MB/s
        assert r["bytes_per_iter"] == 16384 * (4 if r["mode"] == "batched"
                                               else 1)
    ratios = rows[4:]
    assert [r["ratio_mode"] for r in ratios] == ["per_call", "batched"]
    by = {(r["side"], r["mode"]): r["gbps"] for r in sides}
    for r in ratios:
        assert set(r) == {"ratio_mode", "torch_over_cpu"}
        assert r["torch_over_cpu"] == pytest.approx(
            by[("torch", r["ratio_mode"])] / by[("isa", r["ratio_mode"])],
            rel=0.01, abs=0.001)

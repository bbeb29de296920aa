"""Tests that need the card: each CUDA kernel entry against its plain
version on the same device tensors, and the port's codec and backend
on the card against the same on the CPU.  Marked `cuda`; they skip
where no CUDA device is available.  This file imports nothing of JAX
or ceph_tpu, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # a plugin's first fused encode sweeps the operating point: keep its
    # cache inside the test's own directory
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    from ceph_tpu_torch import resolve_device
    return resolve_device("cuda")


def _pin(codec, combine):
    from ceph_tpu_torch.ops import autotune
    codec._fused_point = dict(autotune.default_point(), combine=combine)
    return codec


def _tables(mat, dev):
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    return bs.tables_tensor(gf.product_tables(mat), dev)


@pytest.mark.parametrize("k,r,n", [(8, 3, 1 << 19), (8, 2, 4096 + 16),
                                   (4, 2, 1001), (5, 11, 333), (8, 3, 0)])
def test_k1_kernel_matches_plain(cuda_device, k, r, n):
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(k * 1000 + r + n)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    tab = _tables(mat, cuda_device)
    dev = torch.from_numpy(chunks).to(cuda_device)
    got = bs.gf_bitmatmul(tab, dev)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  bs.gf_bitmatmul_plain(tab, dev).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), gf.gf_matvec(mat, chunks))


@pytest.mark.parametrize("k,m,n,wb", [(8, 3, 1 << 19, 512), (4, 2, 8192, 128),
                                      (10, 9, 4096, 32)])
def test_k2_entries_match_plain(cuda_device, k, m, n, wb):
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(k + m + n)
    tab = _tables(gf.cauchy_rs_matrix(k, m)[k:], cuda_device)
    dev = torch.from_numpy(rng.integers(0, 256, (k, n), dtype=np.uint8)) \
        .to(cuda_device)
    for kern, plain in (
            (lambda: bs.fused_hier_call(tab, dev, wb),
             lambda: bs.fused_hier_call_plain(tab, dev, wb)),
            (lambda: bs.gf_encode_with_crc_w32(tab, dev, 4 * wb),
             lambda: bs.gf_encode_with_crc_w32_plain(tab, dev, 4 * wb))):
        (p1, l1), (p2, l2) = kern(), plain()
        torch.cuda.synchronize()
        assert torch.equal(p1, p2) and torch.equal(l1, l2)


@pytest.mark.parametrize("k,r,n,tile,groups", [
    (8, 3, 1 << 19, None, None),           # the sweep's default G = 4
    (8, 3, 1 << 19, 65536, None),
    (8, 3, 1 << 20, 1 << 20, None),        # one block
    (8, 2, 4096 + 16, None, None),
    (4, 2, 1001, None, None),              # ragged, G = 2
    (6, 3, 333, 256, None),                # k the TPU kernel refused
    (10, 4, 5000, None, None),             # G = 4 does not divide k
    (5, 11, 333, None, 8),                 # two row groups of 8 and 3
    (32, 1, 4096, None, 32),
    (3, 3, 100, 16, None),                 # G = 1
    (8, 3, 0, None, None)])
def test_k4_matches_plain_and_k1(cuda_device, k, r, n, tile, groups):
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(k * 7 + r + n)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    tab = _tables(mat, cuda_device)
    dev = torch.from_numpy(chunks).to(cuda_device)
    before = bs.gf_bitmatmul_stream.launches
    got = bs.gf_bitmatmul_stream(tab, dev, tile=tile, groups=groups)
    k1 = bs.gf_bitmatmul(tab, dev, tile=tile)
    torch.cuda.synchronize()
    assert bs.gf_bitmatmul_stream.launches == before + (n > 0)
    want = bs.gf_bitmatmul_stream_plain(tab, dev, groups).cpu().numpy()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(k1.cpu().numpy(), want)
    np.testing.assert_array_equal(want, gf.gf_matvec(mat, chunks))


def test_k2_byte_entry_matches_plain(cuda_device):
    """K2's byte entry (Pallas #6's contract) against its plain version,
    which takes the byte crc matrix, and against the w32 entry."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(66)
    tab = _tables(gf.cauchy_rs_matrix(8, 3)[8:], cuda_device)
    for n in (1 << 19, 2048, 6144):
        dev = torch.from_numpy(rng.integers(0, 256, (8, n), dtype=np.uint8)) \
            .to(cuda_device)
        before = bs.gf_encode_with_crc.launches
        p1, l1 = bs.gf_encode_with_crc(tab, dev)
        p2, l2 = bs.gf_encode_with_crc_plain(tab, dev)
        p3, l3 = bs.gf_encode_with_crc_w32(tab, dev)
        torch.cuda.synchronize()
        assert bs.gf_encode_with_crc.launches == before + 1
        assert torch.equal(p1, p2) and torch.equal(l1, l2)
        assert torch.equal(p1, p3) and torch.equal(l1, l3)
        assert l1.shape == (11, n // 2048)


def test_bytes_submit_does_not_synchronise(cuda_device):
    """The byte branch of the extents path (use_w32=False) queues K2's
    byte entry and the per-run folds without waiting for the card, and
    agrees with the CPU codec on the same branch."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    reg = ErasureCodePluginRegistry.instance()
    gpu = reg.factory("torch", {"k": "8", "m": "3",
                                "device": str(cuda_device)})
    cpu = reg.factory("torch", {"k": "8", "m": "3", "device": "cpu"})
    gpu._use_w32 = cpu._use_w32 = False
    rng = np.random.default_rng(16)
    runs = [rng.integers(0, 256, (8, w), dtype=np.uint8)
            for w in (1 << 19, 8192, 3000)]
    gpu.encode_extents_with_crc_finalize(         # warm the caches
        gpu.encode_extents_with_crc_submit(runs))
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = gpu.encode_extents_with_crc_submit(runs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert h["path"] == "bytes" and gpu._fused_point is None
    for a, b in zip(gpu.encode_extents_with_crc_finalize(h),
                    cpu.encode_extents_with_crc(runs)):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]


@pytest.mark.parametrize("combine", ["xla", "kernel"])
def test_submit_does_not_synchronise(cuda_device, combine):
    """The dispatch half of the extents path (K2 + folds, or K3 with its
    pinned run-metadata copy) and the plain encode queue their work
    without waiting for the card: finalize is the only place that
    synchronises."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    codec = _pin(ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "8", "m": "3", "device": str(cuda_device)}), combine)
    rng = np.random.default_rng(6)
    runs = [rng.integers(0, 256, (8, w), dtype=np.uint8)
            for w in (1 << 19, 8192, 3000)]
    codec.encode_extents_with_crc_finalize(      # warm the caches
        codec.encode_extents_with_crc_submit(runs))
    codec.encode_chunks_finalize(codec.encode_chunks_submit(runs[1]))
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = codec.encode_extents_with_crc_submit(runs)
        hp = codec.encode_chunks_submit(runs[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(codec.encode_extents_with_crc_finalize(h)) == 3
    assert codec.encode_chunks_finalize(hp).shape == (3, 8192)


def test_plugin_on_card_matches_cpu(cuda_device):
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    reg = ErasureCodePluginRegistry.instance()
    prof = {"k": "8", "m": "3"}
    gpu = _pin(reg.factory("torch", dict(prof, device=str(cuda_device))),
               "xla")
    cpu = _pin(reg.factory("torch", dict(prof, device="cpu")), "xla")
    rng = np.random.default_rng(4)
    chunks = rng.integers(0, 256, (8, 4096 * 3 + 64), dtype=np.uint8)
    np.testing.assert_array_equal(gpu.encode_chunks(chunks),
                                  cpu.encode_chunks(chunks))
    seeds = [int(x) for x in rng.integers(0, 2 ** 32, 11)]
    pg, cg = gpu.encode_chunks_with_crc(chunks, seeds)
    pc, cc = cpu.encode_chunks_with_crc(chunks, seeds)
    np.testing.assert_array_equal(pg, pc)
    assert cg == cc
    allsh = np.concatenate([chunks, pc])
    dense = allsh.copy()
    dense[[0, 5, 9]] = 0
    np.testing.assert_array_equal(gpu.decode_chunks(dense, [0, 5, 9]), allsh)
    runs = [rng.integers(0, 256, (8, w), dtype=np.uint8)
            for w in (1 << 17, 5000, (1 << 18) + 100)]
    hg = gpu.encode_extents_with_crc_submit(runs)
    assert hg["path"] == "hier_lsub+w32_flat"
    for a, b in zip(gpu.encode_extents_with_crc_finalize(hg),
                    cpu.encode_extents_with_crc(runs)):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]


@pytest.mark.parametrize("k,m,wb,blocks", [
    (8, 3, 512, [256]),                    # one 512 KiB run
    (8, 3, 512, [256, 151]),               # two runs
    (4, 2, 128, [3, 0, 1, 9, 2]),          # an empty run among them
    (10, 4, 1024, [1, 1, 70])])
def test_k3_matches_plain(cuda_device, k, m, wb, blocks):
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(sum(blocks) + k)
    tab = _tables(gf.cauchy_rs_matrix(k, m)[k:], cuda_device)
    n = 4 * wb * sum(blocks)
    dev = torch.from_numpy(rng.integers(0, 256, (k, n), dtype=np.uint8)) \
        .to(cuda_device)
    _staged, ends = bs._acc_launch_args(blocks, cuda_device)
    before = bs.fused_hier_acc_call.launches
    p1, l1 = bs.fused_hier_acc_call(tab, dev, ends, wb)
    p2, l2 = bs.fused_hier_acc_call_plain(tab, dev, ends, wb)
    torch.cuda.synchronize()
    assert bs.fused_hier_acc_call.launches == before + 1
    assert torch.equal(p1, p2) and torch.equal(l1, l2)
    assert l1.shape == (len(blocks), k + m)


def test_fold_entry_and_codec_on_card_match_cpu(cuda_device):
    """The single-extent fold at both combines and the plugin's
    device-resident entries on the card against the CPU codec."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import bitsliced as bs
    reg = ErasureCodePluginRegistry.instance()
    gpu = reg.factory("torch", {"k": "8", "m": "3",
                                "device": str(cuda_device)})
    cpu = reg.factory("torch", {"k": "8", "m": "3", "device": "cpu"})
    rng = np.random.default_rng(12)
    chunks = rng.integers(0, 256, (8, 1 << 17), dtype=np.uint8)
    dev = torch.from_numpy(chunks).to(cuda_device)
    want = bs.gf_encode_with_crc_w32_fold(cpu._enc_tables,
                                          torch.from_numpy(chunks))
    for combine in ("xla", "kernel"):
        par, l = bs.gf_encode_with_crc_w32_fold(gpu._enc_tables, dev,
                                                combine=combine)
        assert torch.equal(par.cpu(), want[0])
        assert torch.equal(l.cpu(), want[1])
    odd = torch.from_numpy(chunks[:, :1000].copy())
    assert torch.equal(gpu.encode_chunks_device(odd.to(cuda_device)).cpu(),
                       cpu.encode_chunks_device(odd))
    stripes = torch.from_numpy(rng.integers(0, 256, (5, 8, 4096),
                                            dtype=np.uint8))
    assert torch.equal(gpu.encode_stripes(stripes.to(cuda_device)).cpu(),
                       cpu.encode_stripes(stripes))
    surv = (0, 1, 2, 4, 5, 6, 8, 9)
    assert torch.equal(
        gpu.decode_chunks_device(odd.to(cuda_device), surv, (3, 7)).cpu(),
        cpu.decode_chunks_device(odd, surv, (3, 7)))


def test_autotune_sweep_on_card(cuda_device, monkeypatch):
    """The sweep on the card: every candidate validates, the winner is
    cached under this card's key, and a second plugin init reads it
    without measuring."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import autotune
    reg = ErasureCodePluginRegistry.instance()
    codec = reg.factory("torch", {"k": "8", "m": "3",
                                  "device": str(cuda_device)})
    report = []
    best = autotune.fused_operating_point(
        8, 3, tables=codec._enc_tables, mat=codec.matrix[8:], force=True,
        report=report)
    assert len(report) == 6 and all(r for _, r in report)
    assert best in [c for c, _ in report]
    key = autotune._device_key(cuda_device, 8, 3)
    assert key.startswith(f"cuda/{torch.cuda.get_device_name(cuda_device)}/sm")
    assert autotune._load_cache()["entries"][key]["wb"] == best["wb"]
    calls = []
    monkeypatch.setattr(autotune, "_measure", lambda *a: calls.append(a))
    again = reg.factory("torch", {"k": "8", "m": "3",
                                  "device": str(cuda_device)})
    assert again.fused_point() == best and not calls

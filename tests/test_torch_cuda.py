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
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ceph_tpu_torch import resolve_device
    return resolve_device("cuda")


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


def test_submit_does_not_synchronise(cuda_device):
    """The dispatch half of the extents path and the plain encode queue
    their work without waiting for the card: finalize is the only
    place that synchronises."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "8", "m": "3", "device": str(cuda_device)})
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
    gpu = reg.factory("torch", dict(prof, device=str(cuda_device)))
    cpu = reg.factory("torch", dict(prof, device="cpu"))
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

"""Tests that need the card: each CUDA kernel entry against its plain
version on the same device tensors, and the port's codec and backend
on the card against the same on the CPU.  Marked `cuda`; they skip
where no CUDA device is available.  This file imports nothing of JAX
or ceph_tpu, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import time

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


def _check_k1(device, k, r, n, tile=None, thread_bytes=None, seed=0):
    """K1 on the card against its plain version and the host GF(2^8)
    apply, one launch counted (none for N = 0)."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(seed + k * 1000 + r + n)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    tab = _tables(mat, device)
    dev = torch.from_numpy(chunks).to(device)
    before = bs.gf_bitmatmul.launches
    got = bs.gf_bitmatmul(tab, dev, tile=tile, thread_bytes=thread_bytes)
    torch.cuda.synchronize()
    assert bs.gf_bitmatmul.launches == before + (n > 0)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  bs.gf_bitmatmul_plain(tab, dev).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), gf.gf_matvec(mat, chunks))


@pytest.mark.parametrize("thread_bytes", [None, 4, 16])
@pytest.mark.parametrize("k,r,n,tile", [
    (8, 3, 1 << 19, None), (8, 2, 4096 + 16, None),
    (4, 2, 1001, None),                    # N % 4 != 0
    (8, 3, 4096 + 4, None),                # N % 16 != 0, N % 4 == 0
    (5, 11, 333, None), (8, 3, 0, None),
    (8, 3, 1 << 16, 4096), (6, 2, 5000, 256),  # a given tile
    (8, 3, 1 << 22, None)])                # the --batch 32 width
def test_k1_kernel_matches_plain(cuda_device, k, r, n, tile, thread_bytes):
    _check_k1(cuda_device, k, r, n, tile, thread_bytes)


@pytest.mark.parametrize("r", [1, 2, 3, 4, 5, 8, 11])
@pytest.mark.parametrize("thread_bytes", [4, 16])
def test_k1_packed_groups(cuda_device, r, thread_bytes):
    """Partial and multiple groups of four rows in one pass."""
    from ceph_tpu_torch.ops import bitsliced as bs
    assert bs.k1_smem(r, 8) == (-(-r // 4), -(-r // 4) * 8 * 1024)
    _check_k1(cuda_device, 8, r, 5000 + 4 * r, thread_bytes=thread_bytes)


@pytest.mark.parametrize("thread_bytes", [4, 16])
@pytest.mark.parametrize("k,r,stage_groups", [
    (100, 9, 1),                           # passes of four rows
    (300, 3, 0),                           # k > 227: the byte-table branch
    (908, 1, 0)])                          # at the shared-memory limit
def test_k1_large_k_layouts(cuda_device, k, r, stage_groups, thread_bytes):
    from ceph_tpu_torch.ops import bitsliced as bs
    assert bs.k1_smem(r, k)[0] == stage_groups
    _check_k1(cuda_device, k, r, 3000 + 4, thread_bytes=thread_bytes)


def test_k1_threshold_sides(cuda_device):
    """Both bytes a thread on either side of k1_launch's threshold; past
    the shared-memory limit (r*k*256 bytes) the wrapper raises."""
    from ceph_tpu_torch.ops import bitsliced as bs
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    wide = bs.K1_WIDE_ROW_BYTES_PER_SM * sms
    assert bs.k1_launch(wide - 16, 8, 3, sms)[0] == 4
    assert bs.k1_launch(wide, 8, 3, sms)[0] == 16
    for n in (wide - 16, wide):
        for tb in (4, 16):
            _check_k1(cuda_device, 8, 3, n, thread_bytes=tb, seed=tb)
    tab = torch.zeros((1, 909, 256), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        bs.gf_bitmatmul(tab, torch.zeros((909, 64), dtype=torch.uint8,
                                         device=cuda_device))


@pytest.mark.parametrize("k,m,n,wb", [(8, 3, 1 << 19, 512), (4, 2, 8192, 128),
                                      (10, 9, 4096, 32),
                                      (8, 3, 1 << 16, 256),     # B = 1 KiB
                                      (8, 3, 1 << 17, 1024),    # B = 4 KiB
                                      (12, 4, 6 << 11, 512),    # 16 rows
                                      (4, 2, 2000 << 7, 32),    # > the grid
                                      # the narrow branch: one group, two
                                      # groups over more blocks than the
                                      # grid, odd pieces
                                      (20, 4, 3 << 13, 2048),
                                      (18, 6, 140 << 13, 2048),
                                      (28, 1, 2 * 7552, 1888)])
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
    (8, 3, 1 << 19, None, None),           # the sweep's shape, one pass
    (8, 3, 1 << 19, 65536, None),
    (8, 3, 1 << 20, 1 << 20, None),        # one block
    (8, 2, 4096 + 16, None, None),
    (4, 2, 1001, None, None),              # ragged, 4 bytes a thread
    (6, 3, 333, 256, None),                # k the TPU kernel refused
    (10, 4, 5000, None, 4),                # passes of 3, 3, 3 and 1 rows
    (5, 11, 333, None, 8),                 # one row a pass, three groups
    (32, 1, 4096, None, 32),
    (3, 3, 100, 16, None),
    (8, 3, 0, None, None),                 # a zero width
    (8, 3, 1 << 19, None, 1),              # forced passes at #7's shape
    (8, 3, 1 << 19, None, 2),
    (8, 3, 1 << 19, None, 4),
    (8, 3, 1 << 19, None, 8),
    (176, 64, 32 * 8192, None, None),      # CLAY k=8 m=4 d=11, 32 objects
    (176, 64, 8192, None, None),           # one object
    (270, 81, 6473, None, None),           # CLAY k=8 m=3 d=10, ragged
    (270, 81, 32 * 6473, None, None),      # two passes, 32 objects
    (270, 81, 32 * 6473, None, 5),
    (176, 64, 0, None, None)])
def test_k4_matches_plain_and_k1(cuda_device, k, r, n, tile, groups):
    """K4 on the card against its plain version (the same passes), the
    host GF(2^8) apply where it is quick, and K1 where K1 serves the
    shape (its product tables fit one block)."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(k * 7 + r + n)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    tab = _tables(mat, cuda_device)
    dev = torch.from_numpy(chunks).to(cuda_device)
    before = bs.gf_bitmatmul_stream.launches
    got = bs.gf_bitmatmul_stream(tab, dev, tile=tile, groups=groups)
    torch.cuda.synchronize()
    assert bs.gf_bitmatmul_stream.launches == before + (n > 0)
    want = bs.gf_bitmatmul_stream_plain(tab, dev, groups).cpu().numpy()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if r * k * 256 <= bs.SMEM_LIMIT:
        k1 = bs.gf_bitmatmul(tab, dev, tile=tile)
        np.testing.assert_array_equal(k1.cpu().numpy(), want)
    if r * k * n <= 1 << 25:
        np.testing.assert_array_equal(want, gf.gf_matvec(mat, chunks))


def test_clay_repair_plan_on_card_matches_host(cuda_device):
    """ClayRepairPlan.apply_batch on the card (K4) against codec.repair
    on the host for every lost chunk of k=8 m=4 d=11, 3 objects of 8 KiB
    sub-chunks, one K4 launch a batch."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.parallel import ClayRepairPlan
    codec = ErasureCodePluginRegistry.instance().factory(
        "clay", {"k": "8", "m": "4", "d": "11"})
    sub, s = codec.get_sub_chunk_count(), 8192
    rng = np.random.default_rng(11)
    encs = [codec.encode(set(range(12)), rng.integers(
        0, 256, 8 * sub * s, dtype=np.uint8).tobytes()) for _ in range(3)]
    for lost in range(12):
        plan = ClayRepairPlan.build(codec, lost, device=cuda_device)
        planes = codec.repair_planes(lost)
        helpers = [{ch: np.asarray(e[ch]).reshape(sub, s)[planes]
                    for ch in plan.helper_ids} for e in encs]
        before = bs.gf_bitmatmul_stream.launches
        outs = plan.apply_batch([codec.repair_rows(lost, h)
                                 for h in helpers])
        assert bs.gf_bitmatmul_stream.launches == before + 1
        for e, h, out in zip(encs, helpers, outs):
            np.testing.assert_array_equal(out.reshape(-1), e[lost])
        np.testing.assert_array_equal(
            outs[0].reshape(-1), codec.repair(lost, helpers[0], s))


def _clay_tables(profile, cuda_device):
    """(matrix, its tables by tables_tensor) of every lost chunk of a
    CLAY profile: the tables the listed launch knows."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.parallel import ClayRepairPlan
    k, m, d = profile
    codec = ErasureCodePluginRegistry.instance().factory(
        "clay", {"k": str(k), "m": str(m), "d": str(d)})
    plans = [ClayRepairPlan.build(codec, lost, device=cuda_device)
             for lost in range(k + m)]
    return [(p.matrix, p.tables_tensor()) for p in plans]


@pytest.mark.parametrize("profile,n", [((8, 4, 11), 2 * 8192),
                                       ((8, 4, 11), 8192 + 5),
                                       ((8, 3, 10), 2 * 6473),
                                       ((8, 3, 10), 1001)])
def test_k4_listed_matches_plain_on_every_clay_plan(cuda_device, profile, n):
    """The listed launch on every repair plan of k8m4d11 (12) and k8m3d10
    (11), 16-byte and ragged widths, against K4's plain version; each
    launch skips source rows."""
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(n)
    for mat, tab in _clay_tables(profile, cuda_device):
        lay, packed = bs.k4_layout_of(tab)
        assert lay.skips and packed is not None
        x = torch.from_numpy(rng.integers(0, 256, (mat.shape[1], n),
                                          dtype=np.uint8)).to(cuda_device)
        bs.reset_launch_counts()
        got = bs.gf_bitmatmul_stream(tab, x)
        torch.cuda.synchronize()
        assert bs.k4_support_counts() == {
            "launches": 1, "rows_looked_up": lay.listed,
            "rows_dense": len(lay.lists) * mat.shape[1]}
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            bs.gf_bitmatmul_stream_plain(tab, x).cpu().numpy())


@pytest.mark.parametrize("zeros", [0.0, 0.5, 0.92])
@pytest.mark.parametrize("r,k,n,tile,groups", [
    (64, 176, 32 * 8192, None, None), (81, 270, 6473, None, None),
    (13, 300, 1001, None, 3), (9, 40, 333, 64, None),
    (3, 8, 1 << 19, None, None), (22, 250, 4096 + 16, None, 2)])
def test_k4_listed_matches_plain_on_random_sparse_matrices(
        cuda_device, zeros, r, k, n, tile, groups):
    """Random matrices at 0%, 50% and 92% zeros (and one zero row):
    K4 from tables_tensor against its plain version; a 0% matrix takes
    the dense launch."""
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(int(zeros * 100) + r + k + n)
    mat = rng.integers(1, 256, (r, k), dtype=np.uint8)
    mat[rng.random((r, k)) < zeros] = 0
    if zeros:
        mat[r // 2] = 0
    tab = _tables(mat, cuda_device)
    x = torch.from_numpy(rng.integers(0, 256, (k, n),
                                      dtype=np.uint8)).to(cuda_device)
    bs.reset_launch_counts()
    got = bs.gf_bitmatmul_stream(tab, x, tile=tile, groups=groups)
    torch.cuda.synchronize()
    assert bs.k4_support_counts()["launches"] == int(
        zeros > 0 and not bs.k1_tables_fit(r, k))
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        bs.gf_bitmatmul_stream_plain(tab, x, groups).cpu().numpy())


@pytest.mark.parametrize("n", [1001, 2 * 8192, 8192 + 5])
def test_k4_listed_with_a_group_of_every_source_row(cuda_device, n):
    """12 x 100 tables (K4's, not K1's) whose first group lists all 100
    source rows and whose others skip: the listed launch, one group a
    block, against the plain version."""
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(n)
    mat = rng.integers(1, 256, (12, 100), dtype=np.uint8)
    mat[4:][rng.random((8, 100)) < 0.5] = 0
    tab = _tables(mat, cuda_device)
    lay, _ = bs.k4_layout_of(tab)
    assert lay.longest == 100 and lay.skips
    x = torch.from_numpy(rng.integers(0, 256, (100, n),
                                      dtype=np.uint8)).to(cuda_device)
    bs.reset_launch_counts()
    got = bs.gf_bitmatmul_stream(tab, x)
    torch.cuda.synchronize()
    assert bs.k4_support_counts() == {
        "launches": 1, "rows_looked_up": lay.listed, "rows_dense": 300}
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        bs.gf_bitmatmul_stream_plain(tab, x).cpu().numpy())


def test_k4_unknown_tables_take_the_dense_launch(cuda_device):
    """A tables tensor made without tables_tensor (here: straight from
    the product tables, and a clone) takes the dense launch, rows looked
    up = rows dense, and computes the same bytes as the listed one."""
    from ceph_tpu_torch.ec import gf
    from ceph_tpu_torch.ops import bitsliced as bs
    mat, tab = _clay_tables((8, 4, 11), cuda_device)[0]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, (176, 4 * 8192),
                                      dtype=np.uint8)).to(cuda_device)
    listed = bs.gf_bitmatmul_stream(tab, x)
    for other in (torch.from_numpy(gf.product_tables(mat)).to(cuda_device),
                  tab.clone()):
        assert bs.k4_layout_of(other) is None
        bs.reset_launch_counts()
        got = bs.gf_bitmatmul_stream(other, x)
        torch.cuda.synchronize()
        assert bs.k4_support_counts() == {"launches": 0,
                                          "rows_looked_up": 16 * 176,
                                          "rows_dense": 16 * 176}
        assert torch.equal(got, listed)


def test_k4_support_counts_at_the_cell_shape(cuda_device):
    """The cell's call: 64 objects of 8 KiB sub-chunks, every lost chunk
    of k8m4d11; the groups look up 17 of 176 source rows."""
    from ceph_tpu_torch.ops import bitsliced as bs
    x = torch.zeros((176, 64 * 8192), dtype=torch.uint8, device=cuda_device)
    tables = _clay_tables((8, 4, 11), cuda_device)
    bs.reset_launch_counts()
    for _, tab in tables:
        bs.gf_bitmatmul_stream(tab, x)
    torch.cuda.synchronize()
    got = bs.k4_support_counts()
    assert got["launches"] == 12
    assert got["rows_looked_up"] * 176 == got["rows_dense"] * 17
    assert bs.launch_counts()["gf_bitmatmul_stream"] == 12


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
    (10, 4, 1024, [1, 1, 70]),
    (8, 3, 256, [512]),                    # the autotuner's other blocks
    (8, 3, 1024, [128, 3]),
    (8, 3, 512, [1]),                      # a run of one block (distance 0)
    (8, 3, 512, [1500, 1, 700]),           # more blocks than the grid
    (8, 6, 512, [40, 9]),                  # m > 4: two packed groups
    (8, 3, 512, [0, 64, 5]),               # an empty first run
    (5, 3, 96, [7, 2]),                    # odd pieces: two pad words
    (8, 3, 512, [256] * 32),               # the benchmark's call
    (8, 3, 512, [300, 500, 1000]),         # ranges of 6-7 over run ends
    (8, 3, 512, [2000]),                   # a run of many ranges
    (4, 4, 512, [64, 3]),                  # LRC's 4 x 4 generator shape
    (8, 3, 256, [2000, 7]),                # K2's rows, two stages
    (8, 3, 1024, [600, 5]),                # K2's rows, three stages
    (77, 1, 512, [300]),                   # one stage of K2's rows
    (60, 1, 512, [300])])                  # one stage of scrub rows
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


# -- recovery through the launch queue (phase H's path) ----------------------

def _storm(device, plugin, profile, n_pgs, n_objects, chunk, missing,
           window_us=1e6):
    """n_pgs backends sharing one ECLaunchQueue on `device`: write
    n_objects objects of two stripes a PG through the queue, lose
    `missing`, and recover every PG's objects with every PG's
    recover_shards_submit before any recover_shards_finalize.  Returns
    (the rebuilt shards by (pg, name, shard), the queue's status, the
    kernel launches during the recovery)."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction, shard_oid
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t, pg_t
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.store import MemStore
    from ceph_tpu_torch.store.object_store import Transaction
    queue = ECLaunchQueue(window_us=window_us, device=device)
    try:
        store = MemStore()
        store.mount()
        bes = []
        for p in range(n_pgs):
            prof = dict(profile)
            if plugin == "torch":
                prof["device"] = str(device)
            codec = ErasureCodePluginRegistry.instance().factory(plugin,
                                                                 prof)
            if plugin == "torch":
                _pin(codec, "kernel")
            k = codec.get_data_chunk_count()
            bes.append(ECBackend(
                codec, StripeInfo(k * chunk, chunk),
                LocalShardBackend(store, pg_t(3, p),
                                  codec.get_chunk_count()),
                launch_queue=queue, device=device))
        rng = np.random.default_rng(77)
        acks = []
        for i in range(n_objects):
            for p, be in enumerate(bes):
                txn = PGTransaction()
                txn.write(hobject_t(pool=3, name=f"o{i}"), 0, rng.integers(
                    0, 256, 2 * be.k * chunk, dtype=np.uint8))
                be.submit_transaction(txn, eversion_t(1, i + 1),
                                      lambda: acks.append(1))
        assert len(acks) == n_pgs * n_objects
        lost = {}
        for p, be in enumerate(bes):
            for i in range(n_objects):
                for s in missing:
                    g = shard_oid(hobject_t(pool=3, name=f"o{i}"), s)
                    lost[(p, f"o{i}", s)] = \
                        store.read(be.shards.cids[s], g).copy()
                    t = Transaction()
                    t.remove(g)
                    store.queue_transactions(be.shards.cids[s], [t])
        pushed = {}
        bs.reset_launch_counts()
        recs = [be.recover_shards_submit(
            [(hobject_t(pool=3, name=f"o{i}"), list(missing))
             for i in range(n_objects)],
            lambda o, p=p: (lambda s, d, h: pushed.__setitem__(
                (p, o.name, s), np.asarray(d).copy())))
            for p, be in enumerate(bes)]
        for be, rec in zip(bes, recs):
            assert all(e is None for e in
                       be.recover_shards_finalize(rec).values())
        if device.type == "cuda":
            torch.cuda.synchronize()
        assert pushed.keys() == lost.keys()
        for key, want in lost.items():
            np.testing.assert_array_equal(pushed[key], want)
        return pushed, queue.status(), bs.launch_counts()
    finally:
        queue.close()


def test_queued_recovery_storm_on_card_matches_cpu(cuda_device):
    """Two PGs sharing one queue, torch k=8 m=3, shards {0, 9} lost:
    the rebuilt shards on the card equal the same storm on the CPU
    plain versions (and the lost bytes); the decodes ran as K1 launches
    and coalesced the two PGs."""
    cpu = torch.device("cpu")
    for missing in ((3,), (0, 9)):
        got, st, launches = _storm(cuda_device, "torch",
                                   {"k": "8", "m": "3"}, 2, 3, 2048,
                                   missing)
        want, st_cpu, _ = _storm(cpu, "torch", {"k": "8", "m": "3"}, 2, 3,
                                 2048, missing)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        assert launches["gf_bitmatmul"] >= 1
        assert st["decode_launches"] == st_cpu["decode_launches"] >= 1
        assert st["cross_pg_launches"] >= 1


def test_queued_clay_repair_on_card_matches_cpu(cuda_device):
    """CLAY k=8 m=4 d=11, two PGs, one chunk lost: repaired from repair
    planes through the queue as one K4 launch, equal to the CPU storm."""
    got, st, launches = _storm(cuda_device, "clay",
                               {"k": "8", "m": "4", "d": "11"}, 2, 2,
                               4096, (2,))
    want, _, _ = _storm(torch.device("cpu"), "clay",
                        {"k": "8", "m": "4", "d": "11"}, 2, 2, 4096, (2,))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert launches["gf_bitmatmul_stream"] == st["repair_launches"] == 1
    assert st["cross_pg_launches"] == 1


def test_queue_window_worker_launches_on_card(cuda_device):
    """The window worker launches from its own thread: two PGs' decodes
    left pending launch when the window expires, on the queue's card,
    and demux equal to the CPU decode."""
    import time

    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    reg = ErasureCodePluginRegistry.instance()
    queue = ECLaunchQueue(window_us=2000.0, device=cuda_device)
    try:
        rng = np.random.default_rng(5)
        cpu = reg.factory("torch", {"k": "4", "m": "2", "device": "cpu"})
        # both PGs' codecs, inputs and CPU oracles exist before the first
        # submit: building a codec on the card between the two submits
        # can outlast the 2 ms window and launch the first decode alone
        pgs = []
        for owner, w in ((1, 4096), (2, 1000)):
            codec = reg.factory("torch", {"k": "4", "m": "2",
                                          "device": str(cuda_device)})
            data = rng.integers(0, 256, (4, w), dtype=np.uint8)
            dense = np.concatenate([data, cpu.encode_chunks(data)])
            dense[1] = 0
            pgs.append((owner, codec, dense, cpu.decode_chunks(dense, [1])))
        want = [oracle for _o, _c, _d, oracle in pgs]
        tickets = [queue.submit_decode(codec, dense, [1], owner=owner)
                   for owner, codec, dense, _oracle in pgs]
        deadline = time.time() + 10
        while queue.status()["launches"] < 1 and time.time() < deadline:
            time.sleep(0.005)
        assert all(t.launched for t in tickets)
        for t, w in zip(tickets, want):
            np.testing.assert_array_equal(t.result(), w)
        st = queue.status()
        assert st["decode_launches"] == st["cross_pg_launches"] == 1
    finally:
        queue.close()


def test_cuda_queue_and_backend_without_gpu_raise(cuda_device, monkeypatch):
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import pg_t
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.store import MemStore
    codec = ErasureCodePluginRegistry.instance().factory(
        "clay", {"k": "4", "m": "2", "d": "5"})
    store = MemStore()
    store.mount()
    shards = LocalShardBackend(store, pg_t(1, 0), 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ECLaunchQueue(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ECBackend(codec, StripeInfo(4 * 1024, 1024), shards)


K5_LENGTHS = [0, 1, 2047, 2048, 2049, 8 << 10, (300 << 10) + 777,
              (1 << 20) + 5]


@pytest.mark.parametrize("block,counts", [
    (2048, [256] * 132),                   # 132 x 512 KiB: one scrub chunk
    (2048, [512] * 11 + [0, 3, 1]),        # 1 MiB rows: two-digit distances
    (2048, [0, 0, 5, 0, 1]),               # empty rows first and between
    (2048, [1]),                           # one block (distance 0)
    (128, [70000, 3]),                     # a three-digit distance
    (384, [7, 2, 30]),                     # odd pieces: two pad words
    (1024, [5000, 1, 2]),
    # the range schedule's edges on the H100's grid (4224 warps):
    (2048, [1, 0, 7, 1, 0, 0, 13, 1] * 64 + [4099]),   # chip_smoke's edge
    (2048, [3, 8445]),                     # ranges of 2: ends inside a row
    (2048, [2, 2, 8444]),                  # ranges of 2: ends at row ends
    (2048, [0, 1, 0, 0, 1, 1, 0, 3, 1, 0] * 1200),  # rows of 0 and 1 block
    (128, [1, 50000, 2]),                  # a row longer than many ranges
    (2048, [3, 0, 2])])                    # fewer blocks than warps
def test_k5_matches_plain(cuda_device, block, counts):
    from ceph_tpu_torch.ops import bitsliced as bs
    rng = np.random.default_rng(sum(counts) + block)
    data = rng.integers(0, 256, sum(counts) * block, dtype=np.uint8)
    dev = torch.from_numpy(data).to(cuda_device)
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int64,
                        device=cuda_device)
    before = bs.crc32c_rows_l.launches
    got = bs.crc32c_rows_l(dev, ends, block)
    torch.cuda.synchronize()
    assert bs.crc32c_rows_l.launches == before + 1
    assert torch.equal(got, bs.crc32c_rows_l_plain(dev, ends, block))


def test_k5_launch_args_on_card(cuda_device):
    # the card takes row ends only through the host check
    from ceph_tpu_torch.ops import bitsliced as bs
    with pytest.raises(ValueError, match="bad row block counts"):
        bs._rows_launch_args([2, -1, 3], 4, cuda_device)
    with pytest.raises(ValueError, match="end at the block count"):
        bs._rows_launch_args([1, 3], 5, cuda_device)
    data = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, 6 * 2048, dtype=np.uint8)).to(cuda_device)
    staged, ends = bs._rows_launch_args([2, 0, 4], 6, cuda_device)
    got = bs.crc32c_rows_l(data, ends)
    torch.cuda.synchronize()
    del staged
    assert ends.device.type == "cuda" and ends.tolist() == [2, 2, 6]
    assert torch.equal(got, bs.crc32c_rows_l_plain(data, ends))


def test_crc32c_rows_device_on_card_matches_host(cuda_device):
    from ceph_tpu_torch.common import crc32c
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops import crc32c_linear as cl
    rng = np.random.default_rng(23)
    rows = [rng.integers(0, 256, n, dtype=np.uint8) for n in K5_LENGTHS]
    seeds = [int(x) for x in rng.integers(0, 2 ** 32, len(rows))]
    before = bs.crc32c_rows_l.launches
    got = cl.crc32c_rows_device(rows, seeds, device=cuda_device)
    assert bs.crc32c_rows_l.launches == before + 1
    assert got == [crc32c.crc32c(r, s) for r, s in zip(rows, seeds)]
    assert got == cl.crc32c_rows_plain(rows, seeds)
    # no row with a body: no launch
    small = rows[:3]
    assert cl.crc32c_rows_device(small, seeds[:3], device=cuda_device) == \
        [crc32c.crc32c(r, s) for r, s in zip(small, seeds)]
    assert bs.crc32c_rows_l.launches == before + 1


def test_scrub_with_repair_on_card_matches_cpu(cuda_device):
    """Deep scrub of a card backend (torch k=8 m=3): K5 verifies, K1
    repairs; errors, repaired list, byte split and bytes equal the same
    PG on the CPU."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.osd import scrub
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction, shard_oid
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t, pg_t
    from ceph_tpu_torch.store import MemStore
    from ceph_tpu_torch.store.object_store import Transaction
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        codec = _pin(ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": "8", "m": "3", "device": str(dev)}), "kernel")
        store = MemStore()
        store.mount()
        shards = LocalShardBackend(store, pg_t(1, 0), 11)
        be = ECBackend(codec, StripeInfo(8 * 4096, 4096), shards)
        rng = np.random.default_rng(31)
        oids = []
        for i in range(6):
            txn = PGTransaction()
            o = hobject_t(pool=1, name=f"s{i}")
            txn.write(o, 0, rng.integers(0, 256, (1 << 20) + 777 * i,
                                         dtype=np.uint8))
            be.submit_transaction(txn, eversion_t(1, i + 1), lambda: None)
            oids.append(o)
        be.flush_pipeline()
        want = {}
        for i, s in ((1, 0), (3, 9), (5, 4)):
            goid = shard_oid(oids[i], s)
            want[(i, s)] = store.read(shards.cids[s], goid).copy()
            t = Transaction()
            t.write(goid, 4099, np.frombuffer(b"\x5a\xa5", dtype=np.uint8))
            store.queue_transactions(shards.cids[s], [t])
        bs.reset_launch_counts()
        res = scrub.scrub_pg(be, oids, deep=True, repair=True,
                             use_device=True, chunk_bytes=4 << 20)
        counts = bs.launch_counts()
        assert res.clean and len(res.repaired) == 3
        for (i, s), w in want.items():
            np.testing.assert_array_equal(
                store.read(shards.cids[s], shard_oid(oids[i], s)), w)
        assert scrub.scrub_pg(be, oids, deep=True).clean
        out.append(([(e.oid.name, e.shard, e.kind, e.detail)
                     for e in res.repaired], res.device_bytes,
                    res.host_bytes, counts))
    (rg, dg, hg, cg), (rc, dc, hc, _) = out
    assert (rg, dg, hg) == (rc, dc, hc)
    assert cg["crc32c_rows_l"] >= 2 and cg["gf_bitmatmul"] >= 1


# -- the mesh, the mesh service and prewarm on the card ----------------------

def test_sharded_mesh_on_card_matches_plugin(cuda_device):
    """A 2x2 mesh that repeats the card (each device's share by K1, the
    partials folded on the card) equals the torch plugin's encode and
    decode on the card, bytes exact."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.parallel.mesh import DistributedStripeCodec, make_mesh
    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": "8", "m": "3", "device": str(cuda_device)})
    mesh = make_mesh(2, 2, [cuda_device] * 4)
    assert mesh.gather == "local"
    dcodec = DistributedStripeCodec(8, 3, mesh)
    rng = np.random.default_rng(61)
    chunks = rng.integers(0, 256, (8, (256 << 10) + 48), dtype=np.uint8)
    before = bs.gf_bitmatmul.launches
    parity = dcodec.encode_flat(chunks)
    assert bs.gf_bitmatmul.launches == before + 4
    np.testing.assert_array_equal(parity, codec.encode_chunks(chunks))
    dense = np.concatenate([chunks, parity])
    erased = (0, 9)
    survivors = tuple(s for s in range(11) if s not in erased)[:8]
    got = dcodec.decode_flat_batch([dense[list(survivors)]] * 2, survivors,
                                   erased)
    want = codec.decode_chunks(dense, list(erased))
    for rows in got:
        for i, e in enumerate(erased):
            np.testing.assert_array_equal(rows[i], want[e])


def test_mesh_service_backend_on_card(cuda_device):
    """A 1x1 MeshService on the card serves an ECBackend: the drain is
    plain-encoded on the mesh, degraded reads rebuild through it, every
    object reads back and the mesh counters say so."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
    from ceph_tpu_torch.osd.ec_transaction import PGTransaction
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    from ceph_tpu_torch.osd.types import eversion_t, hobject_t, pg_t
    from ceph_tpu_torch.parallel.service import MeshService
    from ceph_tpu_torch.store import MemStore
    MeshService.reset()
    try:
        svc = MeshService.configure("1")
        assert svc.status()["shape"] == {"shard": 1, "data": 1}
        codec = ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": "8", "m": "3", "device": str(cuda_device)})
        store = MemStore()
        store.mount()

        class Degraded(LocalShardBackend):
            down: set = set()

            def sub_read(self, shard, oid, off, length, on_done):
                if shard in self.down:
                    on_done(shard, None)
                    return
                super().sub_read(shard, oid, off, length, on_done)
        shards = Degraded(store, pg_t(1, 0), 11)
        be = ECBackend(codec, StripeInfo(8 * 4096, 4096), shards,
                       mesh_service=svc)
        assert be.mesh_codec is not None, be.mesh_error
        rng = np.random.default_rng(63)
        objs = {f"m{i}": rng.integers(0, 256, 1 << 20, dtype=np.uint8)
                for i in range(4)}
        with be.batch():
            for i, (name, data) in enumerate(objs.items()):
                txn = PGTransaction()
                txn.write(hobject_t(pool=1, name=name), 0, data)
                be.submit_transaction(txn, eversion_t(1, i + 1),
                                      lambda: None)
        shards.down = {0, 1}
        for name, data in objs.items():
            np.testing.assert_array_equal(
                be.read(hobject_t(pool=1, name=name)), data)
        dump = be.perf.dump()
        assert dump["ec_mesh_drains"] >= 1 and dump["ec_mesh_errors"] == 0
        assert be.mesh_error is None
    finally:
        MeshService.reset()


def test_prewarm_run_once_on_card(cuda_device):
    """The boot prewarm's default plan runs every entry on the card:
    skipped == 0, and its fused entries took the kernels."""
    from ceph_tpu_torch.ec import ErasureCodePluginRegistry
    from ceph_tpu_torch.ops import compile_cache, prewarm
    from ceph_tpu_torch.ops.profiler import DeviceProfiler
    prewarm.reset_for_tests()
    compile_cache.reset_for_tests()
    try:
        assert compile_cache.enable()
        codec = _pin(ErasureCodePluginRegistry.instance().factory(
            "torch", {"k": "8", "m": "3", "device": str(cuda_device)}),
            "kernel")
        prof = DeviceProfiler()
        st = prewarm.run_once(codec, profiler=prof, budget_s=120.0)
        assert st["skipped"] == 0 and st["done"] == st["planned"]
        assert not st["truncated"]
        assert st["persistent_cache"]["enabled"]
        assert prof.prewarm_summary()["buckets"] == len(set(st["buckets"]))
    finally:
        prewarm.reset_for_tests()
        compile_cache.reset_for_tests()


def test_cluster_on_card(cuda_device):
    """A 6-OSD cluster whose codecs and launch queue run on the card, a
    torch k=4 m=2 pool: writes (the fused kernels), a partial overwrite
    (K1's encode), reads, a deep scrub through the daemons (K5), then
    degraded reads with an OSD down (K1's decode); every shard's
    HashInfo crc holds."""
    from ceph_tpu_torch.common import crc32c as host_crc
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops.profiler import DeviceProfiler
    from ceph_tpu_torch.osd.ec_util import HINFO_KEY, HashInfo
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.tools.vstart import Cluster
    ECLaunchQueue.reset_host()
    DeviceProfiler.reset_host()
    rng = np.random.default_rng(64)
    try:
        with Cluster(n_osds=6, device=str(cuda_device)) as c:
            cl = c.client()
            cl.set_ec_profile("cp", {"plugin": "torch", "k": "4", "m": "2",
                                     "stripe_unit": "4096"})
            cl.create_pool("cpool", "erasure", erasure_code_profile="cp",
                           pg_num=8)
            io = cl.open_ioctx("cpool")
            objs = {f"c{i}": rng.integers(0, 256, (1 << 20) + 4096 * i,
                                          dtype=np.uint8)
                    for i in range(12)}
            bs.reset_launch_counts()
            for name, data in objs.items():
                io.write_full(name, data.tobytes())
            patch = rng.integers(0, 256, 10000, dtype=np.uint8)
            objs["c3"][5000:15000] = patch
            io.write("c3", patch.tobytes(), offset=5000)
            for name, data in objs.items():
                assert io.read(name, len(data)) == data.tobytes()
            errors = device_bytes = 0
            for osd in c.osds:
                for res in osd._asok_scrub({"deep": True}).values():
                    errors += len(res["errors"])
                    device_bytes += res["device_bytes"]
            c.kill_osd(0)
            c.mark_osd_down(0)
            epoch = c.mon.osdmap.epoch
            while any(o.osdmap.epoch < epoch for o in c.osds[1:]):
                time.sleep(0.05)
            for name, data in objs.items():
                assert io.read(name, len(data)) == data.tobytes()
            torch.cuda.synchronize()
            n = bs.launch_counts()
            assert errors == 0 and device_bytes > 0
            assert n["gf_bitmatmul"] > 0 and n["crc32c_rows_l"] > 0
            assert n["fused_hier_acc_call"] + n["fused_hier_call"] + \
                n["gf_encode_with_crc_w32"] > 0
            checked = 0
            for osd in c.osds[1:]:
                for cid in osd.store.list_collections():
                    for oid in osd.store.list_objects(cid):
                        attrs = osd.store.getattrs(cid, oid)
                        if HINFO_KEY not in attrs:
                            continue
                        h = HashInfo.decode(attrs[HINFO_KEY])
                        if h.invalidated:
                            continue
                        data = bytes(osd.store.read(cid, oid))
                        assert host_crc.crc32c(data, 0xFFFFFFFF) == \
                            h.cumulative_shard_hashes[cid.shard]
                        checked += 1
            assert checked > 0
    finally:
        ECLaunchQueue.reset_host()
        DeviceProfiler.reset_host()


def test_proc_cluster_on_card(cuda_device, tmp_path):
    """A mon and 12 OSD processes on BlueStore, every daemon's codecs on
    the card, the kernel library loaded from a cache directory (0
    builds in a daemon), a torch k=8 m=3 pool at the K3 point: writes,
    an overwrite, an OSD SIGKILLed (degraded reads through K1), revived
    to active+clean; every object reads back, a deep scrub through the
    admin sockets finds nothing on the device path, and the daemons
    launched K3, K1 and K5."""
    import json
    import shutil

    from ceph_tpu_torch.common.admin_socket import admin_command
    from ceph_tpu_torch.ops import _build, autotune
    from ceph_tpu_torch.tools.proc_cluster import ProcCluster
    cache = tmp_path / "cache"
    cache.mkdir()
    shutil.copy2(_build.build(), cache)
    point = tmp_path / "pinned.json"
    point.write_text(json.dumps({"version": 2, "entries": {
        autotune._device_key(cuda_device, 8, 3): {
            **autotune.default_point(), "combine": "kernel", "gbps": 0.0,
            "when": "pinned"}}}))
    import os
    os.environ["CEPH_TPU_AUTOTUNE_CACHE"] = str(point)   # the fixture's
    rng = np.random.default_rng(65)                     # monkeypatch undoes
    c = ProcCluster(n_osds=12, objectstore="bluestore", device="cuda",
                    heartbeat_interval=0.0, prewarm=True,
                    compile_cache_dir=str(cache),
                    data_dir=str(tmp_path / "data"),
                    asok_dir=str(tmp_path / "asok"))
    (tmp_path / "asok").mkdir()

    def asok(i, cmd):
        return admin_command(c.asok_path(f"osd.{i}"), cmd, timeout=120)

    launched, base = {}, {}

    def count(ids):
        """Each daemon's launches since its last reading (its boot's
        prewarm left out)."""
        for i in ids:
            now = asok(i, {"prefix": "launch profile"})["kernel_launches"]
            for k, n in now.items():
                launched[k] = launched.get(k, 0) + n - base[i].get(k, 0)
            base[i] = now

    with c:
        for i in range(12):
            assert asok(i, {"prefix": "compile ledger"})[
                "kernel_library"]["builds_in_process"] == 0
            base[i] = asok(i, {"prefix": "launch profile"})[
                "kernel_launches"]
        cl = c.client()
        cl.set_ec_profile("pp", {"plugin": "torch", "k": "8", "m": "3",
                                 "technique": "cauchy",
                                 "stripe_unit": "4096"})
        cl.create_pool("ppool", "erasure", erasure_code_profile="pp",
                       pg_num=8)
        io = cl.open_ioctx("ppool")
        objs = {f"p{i}": rng.integers(0, 256, 4 << 20, dtype=np.uint8)
                for i in range(8)}
        for name, data in objs.items():
            io.write_full(name, data.tobytes())
        patch = rng.integers(0, 256, 65536, dtype=np.uint8)
        objs["p3"][100_000:165_536] = patch
        io.write("p3", patch.tobytes(), offset=100_000)
        pgid = cl.objecter._calc_target(io.pool_id, "p3")[0].pgid
        victim = cl.objecter.osdmap.pg_to_up_acting_osds(pgid)[1][1]
        count([victim])
        c.kill_osd(victim)
        c.mark_osd_down(victim)
        while cl.objecter.osdmap.is_up(victim):
            cl.objecter.refresh_map(timeout=2.0)
        for name, data in objs.items():
            assert io.read(name, len(data)) == data.tobytes()
        c.revive_osd(victim)
        base[victim] = asok(victim, {"prefix": "launch profile"})[
            "kernel_launches"]
        c.wait_active_clean(timeout=300)
        for name, data in objs.items():
            assert io.read(name, len(data)) == data.tobytes()
        errors = device_bytes = 0
        for i in range(12):
            for res in asok(i, {"prefix": "scrub", "deep": True}).values():
                errors += len(res["errors"])
                device_bytes += res.get("device_bytes", 0)
        assert errors == 0 and device_bytes > 0
        count(range(12))
    assert launched["gf_bitmatmul"] > 0 and launched["crc32c_rows_l"] > 0
    assert launched["fused_hier_acc_call"] > 0


def test_rbd_on_card(cuda_device, tmp_path, monkeypatch):
    """An RBD image at order 22 (4 MiB objects) on a torch k=8 m=3 pool
    in a cluster whose codecs run on the card, its point pinned to K3:
    `rbd import` of 8 objects (K3), 4 KiB writes (read-modify-writes:
    K1 encodes), a snapshot, writes under it, `rbd export` of the head
    and `rbd export-diff` up to the snapshot imported into a second
    image; both exports equal the bytes expected."""
    import contextlib
    import io as _io
    import json

    from ceph_tpu_torch.ops import autotune
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops.profiler import DeviceProfiler
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.rbd import Image
    from ceph_tpu_torch.tools import rbd_cli
    from ceph_tpu_torch.tools.vstart import Cluster
    point = tmp_path / "pinned.json"
    point.write_text(json.dumps({"version": 2, "entries": {
        autotune._device_key(cuda_device, 8, 3): {
            **autotune.default_point(), "combine": "kernel", "gbps": 0.0,
            "when": "pinned"}}}))
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_CACHE", str(point))
    ECLaunchQueue.reset_host()
    DeviceProfiler.reset_host()
    rng = np.random.default_rng(66)
    data = rng.integers(0, 256, 32 << 20, dtype=np.uint8)
    (tmp_path / "src").write_bytes(data.tobytes())
    try:
        with Cluster(n_osds=12, device=str(cuda_device)) as c:
            cl = c.client()
            cl.set_ec_profile("rp", {"plugin": "torch", "k": "8", "m": "3",
                                     "technique": "cauchy",
                                     "stripe_unit": "4096"})
            cl.create_pool("rbd", "erasure", erasure_code_profile="rp",
                           pg_num=16)
            io = cl.open_ioctx("rbd")
            base = ["-m", "%s:%d" % tuple(c.mon.addr), "-p", "rbd"]

            def rbd(*argv):
                with contextlib.redirect_stdout(_io.StringIO()):
                    assert rbd_cli.main(base + [str(a) for a in argv]) == 0
            bs.reset_launch_counts()
            rbd("import", tmp_path / "src", "vol")
            img = Image(io, "vol")
            for _ in range(8):
                off = int(rng.integers(0, (32 << 20) // 4096)) * 4096
                patch = rng.integers(0, 256, 4096, dtype=np.uint8)
                data[off:off + 4096] = patch
                img.write(off, patch.tobytes())
            at_snap = data.copy()
            img.snap_create("s1")
            for _ in range(4):
                off = int(rng.integers(0, (32 << 20) // 4096 - 16)) * 4096
                patch = rng.integers(0, 256, 65536, dtype=np.uint8)
                data[off:off + 65536] = patch
                img.write(off, patch.tobytes())
            img.close()
            rbd("export", "vol", tmp_path / "head")
            rbd("export-diff", "vol@s1", tmp_path / "s1.diff")
            rbd("create", "copy", "--size", 32 << 20)
            rbd("import-diff", tmp_path / "s1.diff", "copy")
            rbd("export", "copy", tmp_path / "copy")
            torch.cuda.synchronize()
            n = bs.launch_counts()
        assert (tmp_path / "head").read_bytes() == data.tobytes()
        assert (tmp_path / "copy").read_bytes() == at_snap.tobytes()
        assert n["fused_hier_acc_call"] > 0 and n["gf_bitmatmul"] > 0, n
    finally:
        ECLaunchQueue.reset_host()
        DeviceProfiler.reset_host()


def test_cephfs_on_card(cuda_device, tmp_path, monkeypatch):
    """A CephFS whose data pool is torch k=8 m=3 at the default file
    layout (4 MiB blocks) in a cluster whose codecs run on the card, its
    point pinned to K3: whole-block file writes (K3), a partial
    overwrite (a read-modify-write: K1 encodes), then every file read
    with the OSD of data shard 1 of the first block down (K1 decodes);
    every read equals the bytes written."""
    import json

    from ceph_tpu_torch.fs import CephFS, MDSDaemon
    from ceph_tpu_torch.fs.mds import data_oid
    from ceph_tpu_torch.ops import autotune
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops.profiler import DeviceProfiler
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.tools.vstart import Cluster
    point = tmp_path / "pinned.json"
    point.write_text(json.dumps({"version": 2, "entries": {
        autotune._device_key(cuda_device, 8, 3): {
            **autotune.default_point(), "combine": "kernel", "gbps": 0.0,
            "when": "pinned"}}}))
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_CACHE", str(point))
    ECLaunchQueue.reset_host()
    DeviceProfiler.reset_host()
    rng = np.random.default_rng(67)
    files = {f"/v/f{i}": rng.integers(0, 256, (8 << 20) + 777 * i,
                                      dtype=np.uint8) for i in range(3)}
    try:
        with Cluster(n_osds=12, device=str(cuda_device)) as c:
            cl = c.client()
            cl.set_ec_profile("fp", {"plugin": "torch", "k": "8", "m": "3",
                                     "technique": "cauchy",
                                     "stripe_unit": "4096"})
            cl.create_pool("cephfs_data", "erasure",
                           erasure_code_profile="fp", pg_num=16)
            mds = MDSDaemon(c.mon_addrs)
            fs = CephFS(c.mon_addrs, mds.addr)
            try:
                assert fs.block_size == 4 << 20
                bs.reset_launch_counts()
                fs.makedirs("/v")
                for p, v in files.items():
                    fs.write_file(p, v.tobytes())
                wrote = bs.launch_counts()
                off = (5 << 20) + 3 * 4096
                patch = rng.integers(0, 256, 65536, dtype=np.uint8)
                files["/v/f1"][off:off + patch.size] = patch
                with fs.open("/v/f1", "r+") as f:
                    f.pwrite(patch.tobytes(), off)
                oid = data_oid(fs.stat("/v/f0")["ino"], 0)
                obj = fs.data.client.objecter
                pgid = obj._calc_target(fs.data.pool_id, oid)[0].pgid
                victim = obj.osdmap.pg_to_up_acting_osds(pgid)[1][1]
                c.kill_osd(victim)
                c.mark_osd_down(victim)
                got = {p: fs.read_file(p) for p in files}
                torch.cuda.synchronize()
                n = bs.launch_counts()
            finally:
                fs.shutdown()
                mds.shutdown()
        for p, v in files.items():
            assert got[p] == v.tobytes(), p
        assert wrote["fused_hier_acc_call"] > 0, wrote
        assert n["gf_bitmatmul"] > wrote["gf_bitmatmul"], n
    finally:
        ECLaunchQueue.reset_host()
        DeviceProfiler.reset_host()


def test_rgw_on_card(cuda_device, tmp_path, monkeypatch):
    """An S3 gateway whose data pool is torch k=8 m=3 in a cluster whose
    codecs run on the card, its point pinned to K3: a 4 MiB PUT (one
    full-stripe write, K3), a 64 KiB PUT (K2's flat entry), then both
    GETs with the OSD of data shard 1 of the 4 MiB object down (K1
    decodes); every GET equals the bytes PUT."""
    import json
    import urllib.request

    from ceph_tpu_torch.ops import autotune
    from ceph_tpu_torch.ops import bitsliced as bs
    from ceph_tpu_torch.ops.profiler import DeviceProfiler
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.rgw import S3Gateway
    from ceph_tpu_torch.rgw.store import DATA_POOL, _data_oid
    from ceph_tpu_torch.tools.vstart import Cluster
    point = tmp_path / "pinned.json"
    point.write_text(json.dumps({"version": 2, "entries": {
        autotune._device_key(cuda_device, 8, 3): {
            **autotune.default_point(), "combine": "kernel", "gbps": 0.0,
            "when": "pinned"}}}))
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_CACHE", str(point))
    ECLaunchQueue.reset_host()
    DeviceProfiler.reset_host()
    rng = np.random.default_rng(68)
    objs = {"big": rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes(),
            "small": rng.integers(0, 256, 64 << 10,
                                  dtype=np.uint8).tobytes()}

    def http(method, path, data=None):
        req = urllib.request.Request(base + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()
    try:
        with Cluster(n_osds=12, device=str(cuda_device)) as c:
            cl = c.client()
            cl.set_ec_profile("gp", {"plugin": "torch", "k": "8", "m": "3",
                                     "technique": "cauchy",
                                     "stripe_unit": "4096"})
            cl.create_pool(DATA_POOL, "erasure", erasure_code_profile="gp",
                           pg_num=16)
            gw = S3Gateway(cl, ec_profile="gp")
            try:
                base = f"http://{gw.addr[0]}:{gw.addr[1]}"
                http("PUT", "/card")
                bs.reset_launch_counts()
                wrote = {}
                for name, body in objs.items():
                    http("PUT", f"/card/{name}", body)
                    torch.cuda.synchronize()
                    wrote[name] = bs.launch_counts()
                obj = gw.store.data.client.objecter
                pgid = obj._calc_target(gw.store.data.pool_id,
                                        _data_oid("card", "big"))[0].pgid
                victim = obj.osdmap.pg_to_up_acting_osds(pgid)[1][1]
                c.kill_osd(victim)
                c.mark_osd_down(victim)
                got = {name: http("GET", f"/card/{name}") for name in objs}
                torch.cuda.synchronize()
                n = bs.launch_counts()
            finally:
                gw.shutdown()
        for name, body in objs.items():
            assert got[name] == body, name
        assert wrote["big"]["fused_hier_acc_call"] > 0, wrote
        assert wrote["small"]["gf_encode_with_crc_w32"] > \
            wrote["big"]["gf_encode_with_crc_w32"], wrote
        assert n["gf_bitmatmul"] > wrote["small"]["gf_bitmatmul"], n
    finally:
        ECLaunchQueue.reset_host()
        DeviceProfiler.reset_host()

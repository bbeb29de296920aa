"""The port's accumulator path (K3's plain version on the CPU, the
single-extent fold entry, the extents path at combine="kernel") against
ceph_tpu's accumulator kernel, Pallas kernel #4, run in interpret mode
as ceph_tpu's own tests run it (tests/test_crc_fused.py:400-512).

Inputs are made with numpy from a seed and handed to both sides; the
JAX side gets them as little-endian int32 words.  Every output is a
byte or a crc, so the tolerance is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as jgf
from ceph_tpu.ops import bitsliced as jbs
from ceph_tpu.ops import crc32c_linear as jcl
from ceph_tpu_torch.common import crc32c as tcrc
from ceph_tpu_torch.ec import gf as tgf
from ceph_tpu_torch.ops import bitsliced as tbs
from ceph_tpu_torch.ops import crc32c_linear as tcl

CPU = torch.device("cpu")
K, M = 4, 2


def _tables(mat):
    return tbs.tables_tensor(tgf.product_tables(mat), CPU)


def _words(chunks):
    return jnp.asarray(chunks.view("<u4").view(np.int32))


def _legal_points(k, m, tiles, wbs):
    """Every (tile, wb) the JAX sublane rule (k+m)*(tile/4/wb) % 8 == 0
    allows from the given axes: the alignment edges of kernel #4."""
    return [(tile, wb) for tile in tiles for wb in wbs
            if (tile // 4) % wb == 0
            and ((k + m) * (tile // 4 // wb)) % 8 == 0]


LEGAL = _legal_points(K, M, (1024, 2048, 4096), (64, 128, 256))


def test_legal_points_cover_the_edges():
    assert len(LEGAL) >= 5          # the rule must not silence the sweep


@pytest.mark.parametrize("tile,wb", LEGAL,
                         ids=[f"tile{t}-wb{w}" for t, w in LEGAL])
def test_fold_kernel_matches_pallas_acc(tile, wb):
    """The single-extent fold at combine="kernel" (K3's plain version)
    against gf_encode_with_crc_w32_fold(combine="kernel") in interpret
    mode, three tiles (init + two advance folds on the TPU side), and
    the port's combine="xla" against both."""
    mat = jgf.cauchy_rs_matrix(K, M)[K:]
    rng = np.random.default_rng(tile + wb)
    n = tile * 3
    chunks = rng.integers(0, 256, (K, n), dtype=np.uint8)
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    par_w, lbits = jbs.gf_encode_with_crc_w32_fold(
        bitmat32, jnp.asarray(jcl.crc_tile_matrix_w32(wb)), _words(chunks),
        M, tile=tile, wb=wb, interpret=True, extract="planar",
        combine="kernel")
    want_par = np.asarray(par_w).view("<u4").view(np.uint8).reshape(M, n)
    want_l = jcl.bits_to_u32(np.asarray(lbits)).astype(np.int64)
    for combine in ("kernel", "xla"):
        par, l = tbs.gf_encode_with_crc_w32_fold(
            _tables(mat), torch.from_numpy(chunks), wb, combine)
        np.testing.assert_array_equal(par.numpy(), want_par)
        np.testing.assert_array_equal(l.numpy(), want_l)
    allsh = np.concatenate([chunks, want_par])
    for s in range(K + M):
        assert tcl.fold_run_crc(int(want_l[s]), n, 0xFFFFFFFF) == \
            tcrc.crc32c(allsh[s].tobytes(), 0xFFFFFFFF)


def test_hier_acc_core_matches_pallas_launch():
    """One multi-run launch: the port's _hier_acc_core (block counts)
    against ceph_tpu's _acc_launch_args + _hier_acc_core (tile counts)
    on the same words — one L per (run, shard)."""
    tile, wb = 2048, 64
    block = 4 * wb
    ntiles_run = [3, 1, 2]
    mat = jgf.cauchy_rs_matrix(K, M)[K:]
    rng = np.random.default_rng(31)
    n = tile * sum(ntiles_run)
    chunks = rng.integers(0, 256, (K, n), dtype=np.uint8)
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    run_map, first_map, adv, comb = jbs._acc_launch_args(ntiles_run, tile, wb)
    par_w, lb = jbs._hier_acc_core(
        bitmat32, jnp.asarray(jcl.crc_tile_matrix_w32(wb)), adv, comb,
        run_map, first_map, _words(chunks), M, tile, wb, len(ntiles_run),
        True, "planar")
    want_l = jcl.bits_to_u32(np.asarray(lb)).astype(np.int64)  # (nruns, r)
    par, lacc, staged = tbs._hier_acc_core(
        _tables(mat), torch.from_numpy(chunks),
        [t * tile // block for t in ntiles_run], wb)
    np.testing.assert_array_equal(
        par.numpy(), np.asarray(par_w).view("<u4").view(np.uint8)
        .reshape(M, n))
    np.testing.assert_array_equal(lacc.numpy(), want_l)
    np.testing.assert_array_equal(staged.numpy(),
                                  np.cumsum(ntiles_run) * (tile // block))


def test_k3_plain_empty_run_and_bad_run_ends():
    """An empty run (zero blocks) has L = 0; run ends that do not cover
    the launch are refused."""
    mat = tgf.cauchy_rs_matrix(K, M)[K:]
    rng = np.random.default_rng(32)
    chunks = torch.from_numpy(rng.integers(0, 256, (K, 2048), dtype=np.uint8))
    par, lacc = tbs.fused_hier_acc_call(
        _tables(mat), chunks, torch.tensor([2, 2, 4], dtype=torch.int64),
        wb=128)
    assert lacc.shape == (3, K + M)
    assert not lacc[1].any()
    whole = tbs.fused_hier_acc_call(_tables(mat), chunks,
                                    torch.tensor([4], dtype=torch.int64),
                                    wb=128)[1][0]
    a, b = lacc[0].numpy().astype(np.uint32), lacc[2].numpy()
    for s in range(K + M):            # L(run0 || run2) from the two Ls
        assert tcrc.crc32c_zeros(int(a[s]), 1024) ^ int(b[s]) == int(whole[s])
    for bad in ([3], [2, 1, 4], []):
        with pytest.raises(ValueError):
            tbs.fused_hier_acc_call(_tables(mat), chunks,
                                    torch.tensor(bad, dtype=torch.int64),
                                    wb=128)


def _jax_submit(mat, runs, tile, wb, combine="kernel", extract="planar"):
    bitmat = jnp.asarray(jbs.interleave_bitmatrix(mat), dtype=jnp.int8)
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    return jbs.gf_encode_extents_with_crc_submit(
        bitmat, bitmat32, runs, M, use_w32=True, force_xla=False,
        interpret=True, tile=tile, wb=wb, extract=extract, combine=combine)


def test_multi_extent_acc_matches_pallas():
    """Several runs of different lengths, odd sub-block tails included,
    in one accumulator launch on both sides: path "hier_acc", body ==
    width, empty tails, parity, L and seed-chained crcs equal."""
    tile, wb = 4096, 128
    mat = jgf.cauchy_rs_matrix(K, M)[K:]
    rng = np.random.default_rng(18)
    widths = [tile * 2 + 513, tile * 3, tile + 1, tile]
    runs = [rng.integers(0, 256, (K, w), dtype=np.uint8) for w in widths]
    jh = _jax_submit(mat, runs, tile, wb)
    th = tbs.gf_encode_extents_with_crc_submit(_tables(mat), runs, tile=tile,
                                               wb=wb, combine="kernel")
    assert jh["path"] == th["path"] == "hier_acc"
    assert all(p < 4 * wb for p in th["pads"]) and any(th["pads"])
    want = jbs.gf_encode_extents_with_crc_finalize(jh)
    got = tbs.gf_encode_extents_with_crc_finalize(th)
    seeds = [0xFFFFFFFF] * (K + M)
    for run, (gp, gl, gt, gb), (wp, wl, wt, wbody) in zip(runs, got, want):
        np.testing.assert_array_equal(gp, np.asarray(wp))
        np.testing.assert_array_equal(gl, wl)
        assert gb == wbody == run.shape[1]
        assert gt.shape == (K + M, 0) and wt.shape[1] == 0
        allsh = np.concatenate([run, gp])
        crcs = [tcl.fold_run_crc(int(gl[s]), gb, seeds[s])
                for s in range(K + M)]
        assert crcs == [tcrc.crc32c(allsh[s].tobytes(), seeds[s])
                        for s in range(K + M)]
        seeds = crcs                    # the hinfo chain across runs


def test_mixed_drain_at_kernel_point_splits_like_pallas():
    """A drain mixing runs above and below the hier threshold at the
    kernel point: one accumulator launch and one flat launch, demuxed
    to the caller's order — "hier_acc+w32_flat" on both sides."""
    tile, wb = 4096, 128
    mat = jgf.cauchy_rs_matrix(K, M)[K:]
    rng = np.random.default_rng(20)
    widths = [tile + 300, 700, tile * 2, 2048 + 5]
    runs = [rng.integers(0, 256, (K, w), dtype=np.uint8) for w in widths]
    jh = _jax_submit(mat, runs, tile, wb)
    th = tbs.gf_encode_extents_with_crc_submit(_tables(mat), runs, tile=tile,
                                               wb=wb, combine="kernel")
    assert jh["path"] == th["path"] == "hier_acc+w32_flat"
    assert [i for i, _ in th["split"]] == [[0, 2], [1, 3]]
    for (gp, gl, gt, gb), (wp, wl, wt, wbody) in zip(
            tbs.gf_encode_extents_with_crc_finalize(th),
            jbs.gf_encode_extents_with_crc_finalize(jh)):
        np.testing.assert_array_equal(gp, np.asarray(wp))
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gt, wt)
        assert gb == wbody


def test_acc_chained_seeds_across_pipelined_drains():
    """Two accumulator drains in flight at once (submit A, submit B,
    finalize in order), drain B's seeds chained off drain A's crcs, on
    both sides against the host crc of the concatenated shard
    streams."""
    tile, wb = 4096, 128
    mat = jgf.cauchy_rs_matrix(K, M)[K:]
    rng = np.random.default_rng(19)
    drains = [[rng.integers(0, 256, (K, tile + 257), dtype=np.uint8)],
              [rng.integers(0, 256, (K, tile * 2 + 99), dtype=np.uint8)]]
    jhs = [_jax_submit(mat, d, tile, wb) for d in drains]
    ths = [tbs.gf_encode_extents_with_crc_submit(
        _tables(mat), d, tile=tile, wb=wb, combine="kernel") for d in drains]
    seeds = [0xFFFFFFFF] * (K + M)
    streams = [b""] * (K + M)
    for d, jh, th in zip(drains, jhs, ths):
        [(par, l, tail, body)] = tbs.gf_encode_extents_with_crc_finalize(th)
        [(jpar, jl, jtail, jbody)] = \
            jbs.gf_encode_extents_with_crc_finalize(jh)
        np.testing.assert_array_equal(par, np.asarray(jpar))
        np.testing.assert_array_equal(l, jl)
        allsh = np.concatenate([d[0], par], axis=0)
        crcs = [tcl.fold_run_crc(int(l[s]), body, seeds[s], tail[s].tobytes())
                for s in range(K + M)]
        assert crcs == [jcl.fold_run_crc(int(jl[s]), jbody, seeds[s],
                                         jtail[s].tobytes())
                        for s in range(K + M)]
        for s in range(K + M):
            streams[s] += allsh[s].tobytes()
            assert crcs[s] == tcrc.crc32c(streams[s], 0xFFFFFFFF)
        seeds = crcs


def test_submit_refuses_unknown_combine():
    mat = tgf.cauchy_rs_matrix(K, M)[K:]
    with pytest.raises(ValueError, match="combine"):
        tbs.gf_encode_extents_with_crc_submit(
            _tables(mat), [np.zeros((K, 64), dtype=np.uint8)],
            combine="fast")
    with pytest.raises(ValueError, match="combine"):
        tbs.gf_encode_with_crc_w32_fold(
            _tables(mat), torch.zeros((K, 2048), dtype=torch.uint8),
            combine="fast")

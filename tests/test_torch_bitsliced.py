"""The port's kernel entries (plain versions, on the CPU) against the
Pallas kernels they replace, run in interpret mode as ceph_tpu's own
tests run them, and the multi-extent launch contract against ceph_tpu's.

Inputs are made with numpy from a seed and handed to both sides; the
JAX side gets them as little-endian int32 words.  Every output is a
byte or a crc, so the tolerance is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import gf as jgf
from ceph_tpu.ops import bitsliced as jbs
from ceph_tpu.ops import crc32c_linear as jcl
from ceph_tpu_torch.ec import gf as tgf
from ceph_tpu_torch.ops import bitsliced as tbs
from ceph_tpu_torch.ops import crc32c_linear as tcl

CPU = torch.device("cpu")


def _tables(mat):
    return tbs.tables_tensor(tgf.product_tables(mat), CPU)


def _words(chunks):
    return jnp.asarray(chunks.view("<u4").view(np.int32))


def _unwords(words, rows):
    return np.asarray(words).view("<u4").view(np.uint8).reshape(rows, -1)


def test_k1_plain_matches_pallas_w32_encode():
    k, m, n = 4, 2, 4096
    mat = jgf.cauchy_rs_matrix(k, m)[k:]
    rng = np.random.default_rng(13)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    want = _unwords(jbs.gf_bitmatmul_pallas_w32(
        bitmat32, _words(chunks), m, tile=2048, interpret=True), m)
    got = tbs.gf_bitmatmul(_tables(mat), torch.from_numpy(chunks)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lost", [(0,), (1, 4), (2, 5)])
def test_k1_plain_matches_pallas_w32_decode(lost):
    k, m, n = 4, 2, 4096
    gen = jgf.cauchy_rs_matrix(k, m)
    survivors = tuple(s for s in range(k + m) if s not in lost)[:k]
    coeff = jgf.recovery_matrix(gen, k, survivors, lost)
    rng = np.random.default_rng(sum(lost) + 20)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    allsh = np.concatenate([data, jgf.gf_matvec(gen[k:], data)])
    avail = np.ascontiguousarray(allsh[list(survivors)])
    bitmat32 = jnp.asarray(jbs._w32_bitmat(coeff), dtype=jnp.int8)
    want = _unwords(jbs.gf_bitmatmul_pallas_w32(
        bitmat32, _words(avail), len(lost), tile=2048, interpret=True),
        len(lost))
    got = tbs.gf_bitmatmul(_tables(coeff), torch.from_numpy(avail)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, allsh[list(lost)])


def test_k1_plain_ragged_width_matches_host():
    rng = np.random.default_rng(5)
    mat = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    chunks = rng.integers(0, 256, (5, 1001), dtype=np.uint8)
    got = tbs.gf_bitmatmul(_tables(mat), torch.from_numpy(chunks)).numpy()
    np.testing.assert_array_equal(got, jgf.gf_matvec(mat, chunks))


def test_k2_hier_entry_matches_pallas_hier():
    """Hier entry (contract of kernel #1) against the interpret-mode
    hier kernel: parity, the per-sub-block L (ceph_tpu's
    _fused_hier_call), and per-tile L after the level-2 combine."""
    k, m = 4, 2
    tile, wb = 4096, 128
    n = tile * 2
    r = k + m
    s = tile // 4 // wb
    mat = jgf.cauchy_rs_matrix(k, m)[k:]
    rng = np.random.default_rng(8)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    cmat_sub = jnp.asarray(jcl.crc_tile_matrix_w32(wb))
    combine = jnp.asarray(jcl.crc_combine_matrix(s, 4 * wb))
    par_w, lsub = jbs._fused_hier_call(bitmat32, cmat_sub, _words(chunks),
                                       m, tile, wb, True)
    want_sub = jcl.bits_to_u32(np.asarray(lsub)).reshape(-1, r, s) \
        .transpose(1, 0, 2).reshape(r, -1)                # stream order
    parity, ls = tbs.fused_hier_call(_tables(mat), torch.from_numpy(chunks),
                                     wb)
    np.testing.assert_array_equal(parity.numpy(), _unwords(par_w, m))
    np.testing.assert_array_equal(ls.numpy(), want_sub.astype(np.int64))

    par_t, crc_flat = jbs.gf_encode_with_crc_pallas_w32_hier(
        bitmat32, cmat_sub, combine, _words(chunks), m, tile=tile, wb=wb,
        interpret=True)
    rows = jbs._crc_rows(r)
    want_tile = jcl.bits_to_u32(
        np.asarray(crc_flat).reshape(-1, rows, 32)[:, :r])   # (nt, r)
    nt = n // tile
    lsub_bits = tcl.u32_to_bits(ls.reshape(r, nt, s).permute(1, 0, 2)
                                .reshape(nt * r * s))
    got_tile = tcl.bits_to_u32(tcl.combine_subblock_crcs(
        lsub_bits, torch.from_numpy(tcl.crc_combine_matrix(s, 4 * wb)),
        r, s))
    np.testing.assert_array_equal(got_tile.numpy(),
                                  want_tile.astype(np.int64))
    np.testing.assert_array_equal(parity.numpy(), _unwords(par_t, m))


def test_k2_flat_entry_matches_pallas_w32():
    k, m = 4, 2
    tile = 2048
    n = tile * 3
    r = k + m
    mat = jgf.cauchy_rs_matrix(k, m)[k:]
    rng = np.random.default_rng(9)
    chunks = rng.integers(0, 256, (k, n), dtype=np.uint8)
    bitmat32 = jnp.asarray(jbs._w32_bitmat(mat), dtype=jnp.int8)
    cmat32 = jnp.asarray(jcl.crc_tile_matrix_w32(tile // 4))
    par_w, crc_flat = jbs.gf_encode_with_crc_pallas_w32(
        bitmat32, cmat32, _words(chunks), m, tile=tile, interpret=True)
    rows = jbs._crc_rows(r)
    want = jcl.bits_to_u32(np.asarray(crc_flat).reshape(-1, rows, 32)[:, :r])
    parity, ls = tbs.gf_encode_with_crc_w32(_tables(mat),
                                            torch.from_numpy(chunks), tile)
    np.testing.assert_array_equal(parity.numpy(), _unwords(par_w, m))
    np.testing.assert_array_equal(ls.numpy(), want.T.astype(np.int64))


def test_crc_torch_functions_match_jax():
    """subblock/tile crc bits, combine_crcs_pow2 (odd and pow2 block
    counts) and combine_subblock_crcs against their JAX versions."""
    rng = np.random.default_rng(21)
    wb = 32
    words = rng.integers(-2 ** 31, 2 ** 31, (3, 4 * wb), dtype=np.int64) \
        .astype(np.int32)
    cm = jcl.crc_tile_matrix_w32(wb)
    want = np.asarray(jcl.subblock_crc_bits_w32(jnp.asarray(words),
                                                jnp.asarray(cm), wb))
    got = tcl.subblock_crc_bits_w32(torch.from_numpy(words),
                                    torch.from_numpy(cm), wb)
    np.testing.assert_array_equal(got.numpy(), want)
    cm1 = jcl.crc_tile_matrix_w32(4 * wb)
    np.testing.assert_array_equal(
        tcl.tile_crc_bits_w32(torch.from_numpy(words),
                              torch.from_numpy(cm1)).numpy(),
        np.asarray(jcl.tile_crc_bits_w32(jnp.asarray(words),
                                         jnp.asarray(cm1))))
    for t in (1, 3, 4, 7):
        lb = rng.integers(0, 2, (5, t, 32), dtype=np.int32)
        np.testing.assert_array_equal(
            tcl.combine_crcs_pow2(torch.from_numpy(lb), 64).numpy(),
            np.asarray(jcl.combine_crcs_pow2(jnp.asarray(lb), 64)))
    lsub = rng.integers(0, 2, (2 * 3 * 4, 32), dtype=np.int32)
    comb = jcl.crc_combine_matrix(4, 128)
    np.testing.assert_array_equal(
        tcl.combine_subblock_crcs(torch.from_numpy(lsub),
                                  torch.from_numpy(comb), 3, 4).numpy(),
        np.asarray(jcl.combine_subblock_crcs(jnp.asarray(lsub),
                                             jnp.asarray(comb), 3, 4)))
    bits = rng.integers(0, 2, (4, 32), dtype=np.int32)
    np.testing.assert_array_equal(
        tcl.bits_to_u32(torch.from_numpy(bits)).numpy(),
        jcl.bits_to_u32(bits).astype(np.int64))


def _check_extents_contract(k, m, widths, seed=0):
    mat = jgf.cauchy_rs_matrix(k, m)[k:]
    rng = np.random.default_rng(seed)
    runs = [rng.integers(0, 256, (k, w), dtype=np.uint8) for w in widths]
    bitmat = jnp.asarray(jbs.interleave_bitmatrix(mat), dtype=jnp.int8)
    want = jbs.gf_encode_extents_with_crc(bitmat, None, runs, m)
    handle = tbs.gf_encode_extents_with_crc_submit(_tables(mat), runs)
    got = tbs.gf_encode_extents_with_crc_finalize(handle)
    assert len(got) == len(want)
    seeds = [int(x) for x in rng.integers(0, 2 ** 32, k + m)]
    for (gp, gl, gt, gb), (wp, wl, wt, wbody) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gt, wt)
        assert gb == wbody
        # chained seeds: fold both sides from the same per-shard seeds
        tf = [tcl.fold_run_crc(int(gl[s]), gb, seeds[s], gt[s].tobytes())
              for s in range(k + m)]
        jf = [jcl.fold_run_crc(int(wl[s]), wbody, seeds[s], wt[s].tobytes())
              for s in range(k + m)]
        assert tf == jf
        seeds = tf
    return handle


def test_extents_contract_odd_tails_multi_run():
    h = _check_extents_contract(4, 2, [100, 5000, 2048, 64, 6144 + 7],
                                seed=1)
    assert h["path"] == "w32_flat"


def test_extents_contract_mixed_widths_split_and_demux():
    """Runs at or above the hier threshold (128 KiB per shard) take the
    hier entry, the rest the flat one, demuxed back to caller order."""
    hier = tbs.FUSED_TILE_HIER
    h = _check_extents_contract(2, 1, [hier, 300, hier + 2048 + 5, 2048],
                                seed=2)
    assert h["path"] == "hier_lsub+w32_flat"
    assert [i for i, _ in h["split"]] == [[0, 2], [1, 3]]


def test_extents_contract_all_hier():
    hier = tbs.FUSED_TILE_HIER
    h = _check_extents_contract(4, 2, [hier, hier + 100], seed=3)
    assert h["path"] == "hier_lsub"

"""The port's autotuner (ceph_tpu_torch/ops/autotune.py) on the CPU,
mirroring tests/test_autotune.py: the sweep never ships or caches a
candidate that fails bit-exactness, a cold key seeds its ordering from
the nearest cached winner of the device, candidates are legal and
ordered, and a CPU device gets the default point with no sweep.  The
sweep flow runs on the CPU through the plain versions, reached with
`sweep_on_cpu` as ceph_tpu's tests reach theirs with interpret=True."""

import json

import pytest
import torch

from ceph_tpu.ops import autotune as jat
from ceph_tpu_torch.ec import ErasureCodePluginRegistry, gf
from ceph_tpu_torch.ops import autotune
from ceph_tpu_torch.ops import bitsliced as bs

K, M = 4, 2
CPU = torch.device("cpu")


def _mats():
    mat = gf.cauchy_rs_matrix(K, M)[K:]
    return mat, bs.tables_tensor(gf.product_tables(mat), CPU)


@pytest.fixture()
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_CACHE", str(path))
    return path


def _corrupt_acc(monkeypatch):
    """A plain accumulator that returns wrong-but-well-shaped Ls, the
    signature of a broken K3."""
    real = bs.fused_hier_acc_call_plain

    def bad(tables, chunks, run_ends, wb=bs.FUSED_WB):
        parity, lacc = real(tables, chunks, run_ends, wb)
        return parity, lacc ^ 1
    monkeypatch.setattr(bs, "fused_hier_acc_call_plain", bad)


def test_default_point_matches_jax_keys():
    """Points keep the JAX keys; the static default is the same
    threshold and crc block as ceph_tpu's, at the combine the sweep
    picks on the card (K3's in-kernel fold)."""
    ours, theirs = autotune.default_point(), jat.default_point()
    assert ours.keys() == theirs.keys()
    assert {kk: ours[kk] for kk in ("tile", "wb", "extract")} == \
        {kk: theirs[kk] for kk in ("tile", "wb", "extract")}
    assert ours["combine"] == "kernel"


@pytest.mark.parametrize("combine", ["xla", "kernel"])
@pytest.mark.parametrize("wb", [256, 512, 1024])
def test_validate_accepts_every_candidate(wb, combine):
    mat, tables = _mats()
    cand = {"tile": bs.FUSED_TILE_HIER, "wb": wb, "extract": "planar",
            "combine": combine}
    assert autotune._validate(tables, mat, cand)


def test_validate_rejects_corrupted_accumulator(monkeypatch):
    """A corrupted plain accumulator fails the gate; the K2 + fold
    sibling at the same wb still passes."""
    _corrupt_acc(monkeypatch)
    mat, tables = _mats()
    bad = {"tile": bs.FUSED_TILE_HIER, "wb": 256, "extract": "planar",
           "combine": "kernel"}
    assert not autotune._validate(tables, mat, bad)
    assert autotune._validate(tables, mat, dict(bad, combine="xla"))


def test_validate_rejects_wrong_parity(monkeypatch):
    mat, tables = _mats()
    real = bs.fused_hier_call_plain
    monkeypatch.setattr(bs, "fused_hier_call_plain",
                        lambda t, c, wb=bs.FUSED_WB:
                        (lambda p, ls: (p ^ 1, ls))(*real(t, c, wb)))
    assert not autotune._validate(
        tables, mat, {"tile": bs.FUSED_TILE_HIER, "wb": 256,
                      "extract": "planar", "combine": "xla"})


def test_invalid_candidate_never_cached(monkeypatch, cache_file):
    """The full sweep flow with a corrupted variant that MEASURES
    fastest: rejected at validation (reported None), never the winner,
    never in the persisted cache."""
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_BUDGET_S", "600")
    _corrupt_acc(monkeypatch)
    monkeypatch.setattr(
        autotune, "_measure",
        lambda tables, k, m, cand:
            50e9 if cand["combine"] == "kernel" else 5e9)
    mat, tables = _mats()
    report = []
    best = autotune.fused_operating_point(
        K, M, tables=tables, mat=mat, force=True, report=report,
        sweep_on_cpu=True)
    assert best["combine"] == "xla"
    kernel_rows = [r for c, r in report if c["combine"] == "kernel"]
    assert len(kernel_rows) == 3 and all(r is None for r in kernel_rows)
    assert len(report) == 6
    data = json.loads(cache_file.read_text())
    assert data["version"] == 2
    (key, ent), = data["entries"].items()
    assert key == autotune._device_key(CPU, K, M)
    assert key.endswith(f"/torch{torch.__version__}/"
                        f"{autotune.KERNEL_GEN}/k{K}m{M}")
    assert ent["combine"] == "xla" and ent["gbps"] > 0


def test_cache_hit_measures_nothing(monkeypatch, cache_file):
    """A second lookup of a swept key reads the cached row: no
    validation, no measurement."""
    mat, tables = _mats()
    monkeypatch.setattr(autotune, "_measure",
                        lambda tables, k, m, cand: 1e9 * cand["wb"])
    first = autotune.fused_operating_point(K, M, tables=tables, mat=mat,
                                           sweep_on_cpu=True)
    assert first["wb"] == 1024

    def boom(*a, **kw):
        raise AssertionError("a cache hit must not sweep")
    monkeypatch.setattr(autotune, "_measure", boom)
    monkeypatch.setattr(autotune, "_validate", boom)
    assert autotune.fused_operating_point(K, M, tables=tables, mat=mat,
                                          sweep_on_cpu=True) == first


def test_cold_key_seeds_from_nearest_device_winner(monkeypatch, cache_file):
    """A cold (k, m) key starts its capped sweep from the cached winner
    of the nearest key of this device: a zero-budget sweep measures
    exactly one candidate, the neighbour's point."""
    seed_point = {"tile": bs.FUSED_TILE_HIER, "wb": 1024,
                  "extract": "planar", "combine": "kernel"}
    assert seed_point != autotune.default_point()
    prefix = autotune._device_prefix(CPU)
    cache_file.write_text(json.dumps({
        "version": 2,
        "entries": {f"{prefix}torch0.0.0/{autotune.KERNEL_GEN}/k8m3":
                    {**seed_point, "gbps": 123.0, "when": "x"},
                    "cuda/other card/sm90/torch0.0.0/x/k4m2":
                    {**seed_point, "wb": 256, "gbps": 999.0, "when": "x"}}}))
    tried = []
    monkeypatch.setattr(autotune, "_validate",
                        lambda tables, mat, cand:
                        (tried.append(dict(cand)) or True))
    monkeypatch.setattr(autotune, "_measure",
                        lambda tables, k, m, cand: 7e9)
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE_BUDGET_S", "0")
    mat, tables = _mats()
    best = autotune.fused_operating_point(K, M, tables=tables, mat=mat,
                                          force=True, sweep_on_cpu=True)
    assert tried == [seed_point]
    assert best == seed_point


def test_candidates_ordering_and_legality():
    cands = autotune.candidates(8, 3)
    assert len(cands) == 6
    assert cands[0] == autotune.default_point()
    for c in cands:
        assert autotune._legal(8, 3, c["wb"])
        assert c["extract"] == "planar" and c["tile"] == bs.FUSED_TILE_HIER
    seed = {"tile": bs.FUSED_TILE_HIER, "wb": 256, "extract": "planar",
            "combine": "kernel"}
    seeded = autotune.candidates(8, 3, seed=seed)
    assert seeded[0] == seed
    assert seeded[1] == autotune.default_point()
    assert seeded[2] == dict(seed, combine="xla")    # the seed's wb next
    # a block that is no multiple of 128, and one past shared memory
    wbs = (16, 1 << 16, 256)
    assert [c["wb"] for c in autotune.candidates(8, 3, wbs=wbs)] == [256, 256]


def test_cpu_device_gets_default_without_sweep(monkeypatch, cache_file):
    def boom(*a, **kw):
        raise AssertionError("no sweep on a CPU device")
    monkeypatch.setattr(autotune, "_measure", boom)
    monkeypatch.setattr(autotune, "_validate", boom)
    mat, tables = _mats()
    assert autotune.fused_operating_point(K, M, tables=tables, mat=mat) == \
        autotune.default_point()
    assert not cache_file.exists()
    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": str(K), "m": str(M), "device": "cpu"})
    assert codec.fused_point() == autotune.default_point()
    assert not cache_file.exists()


def test_autotune_disabled_or_unreadable_cache(monkeypatch, cache_file):
    mat, tables = _mats()
    cache_file.write_text("{not json")
    monkeypatch.setenv("CEPH_TPU_AUTOTUNE", "0")
    assert autotune.fused_operating_point(
        K, M, tables=tables, mat=mat, sweep_on_cpu=True) == \
        autotune.default_point()
    assert autotune._load_cache() == {"version": 2, "entries": {}}


def test_plugin_fused_point_raises_on_sweep_error(monkeypatch):
    """A sweep that fails (a kernel that does not build or launch) fails
    the plugin's point lookup: the write path is never moved onto a
    point nobody validated."""
    def boom(*a, **kw):
        raise RuntimeError("sweep failed")
    monkeypatch.setattr(autotune, "fused_operating_point", boom)
    codec = ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": str(K), "m": str(M), "device": "cpu"})
    with pytest.raises(RuntimeError, match="sweep failed"):
        codec.fused_point()
    assert codec._fused_point is None


def test_launch_failure_raises_out_of_the_sweep(monkeypatch, cache_file):
    """A K3 that fails to launch is not an invalid candidate the sweep
    routes around: the error reaches the caller and nothing is cached."""
    def broken(*a, **kw):
        raise RuntimeError("gf_encode_crc_acc: launch failed")
    monkeypatch.setattr(bs, "fused_hier_acc_call_plain", broken)
    monkeypatch.setattr(autotune, "_measure",
                        lambda tables, k, m, cand: 1e9)
    mat, tables = _mats()
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune._validate(tables, mat, autotune.default_point())
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.fused_operating_point(K, M, tables=tables, mat=mat,
                                       sweep_on_cpu=True)
    assert not cache_file.exists()


def test_no_bit_exact_candidate_raises(monkeypatch, cache_file):
    """When every candidate computes wrong crcs the sweep has no point
    to write with: it raises and caches nothing."""
    _corrupt_acc(monkeypatch)
    real = bs.fused_hier_call_plain
    monkeypatch.setattr(bs, "fused_hier_call_plain",
                        lambda t, c, wb=bs.FUSED_WB:
                        (lambda p, ls: (p, ls ^ 1))(*real(t, c, wb)))
    report = []
    mat, tables = _mats()
    with pytest.raises(RuntimeError, match="bit-exact"):
        autotune.fused_operating_point(K, M, tables=tables, mat=mat,
                                       report=report, sweep_on_cpu=True)
    assert len(report) == 6 and all(r is None for _, r in report)
    assert not cache_file.exists()


def test_sweep_cli_validate_only_on_cpu(capsys):
    from ceph_tpu_torch.tools import fused_tile_sweep
    assert fused_tile_sweep.main(["-P", "device=cpu", "--validate-only",
                                  "256", "512"]) == 0
    out = capsys.readouterr().out
    assert out.count(" ok") == 4 and "all 4 candidates bit-exact" in out
    assert fused_tile_sweep.main(["-P", "device=cpu"]) == 0
    assert "static default point" in capsys.readouterr().out
    assert fused_tile_sweep.main(["--bogus"]) == 2


def test_sweep_cli_validate_only_reports_invalid(monkeypatch, capsys):
    from ceph_tpu_torch.tools import fused_tile_sweep
    _corrupt_acc(monkeypatch)
    assert fused_tile_sweep.main(["-P", "device=cpu", "--validate-only",
                                  "512"]) == 1
    out = capsys.readouterr().out
    assert "wb=  512 combine=kernel  INVALID" in out
    assert "1/2 candidates INVALID" in out

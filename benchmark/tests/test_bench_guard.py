"""What a run may load, and a run without a card."""

from __future__ import annotations

import sys

import pytest

from benchmark import run
from benchmark.harness import guard


def test_forbidden_by_whole_top_level_name():
    assert guard.forbidden_loaded(["ceph_tpu", "os"]) == ["ceph_tpu"]
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib.xla_client",
                                   "flax"]) == ["flax", "jax", "jaxlib"]
    assert guard.forbidden_loaded(["ceph_tpu_torch", "ceph_tpu_torch.ops",
                                   "jaxtyping", "ceph_tpu2"]) == []


def _saved():
    return (list(sys.path), sys.pycache_prefix, sys.dont_write_bytecode)


def _restore(saved):
    sys.path[:], sys.pycache_prefix, sys.dont_write_bytecode = saved


def test_caches_inside_the_checkout(tmp_path, monkeypatch):
    env = guard.cache_env(tmp_path / "benchmark")
    assert env["CEPH_TPU_AUTOTUNE"] == "0"
    for key in ("CEPH_TPU_AUTOTUNE_CACHE", "TORCH_EXTENSIONS_DIR",
                "TRITON_CACHE_DIR"):
        assert env[key].startswith(str(tmp_path / "benchmark" / ".cache"))
    for key in env:
        monkeypatch.delenv(key, raising=False)
    saved = _saved()
    try:
        sys.dont_write_bytecode = True
        guard.apply_env(tmp_path / "benchmark")
        assert sys.pycache_prefix == str(tmp_path / "benchmark" / ".cache"
                                         / "pycache")
        assert sys.dont_write_bytecode is False
    finally:
        _restore(saved)


def test_no_card_no_result(monkeypatch, capsys):
    """The measurement path refuses to run without a card, and never
    runs the cell on the CPU instead."""
    import torch
    from benchmark.harness import runner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(runner, "run_cell",
                        lambda *a, **k: ran.append(a) or {})
    saved = _saved()
    try:
        rc = run.main(["--workload", "k8m3-encode-4m", "--seed",
                       str(2**31 + 5), "--seconds", "1"])
    finally:
        _restore(saved)
    out = capsys.readouterr()
    assert rc == 2 and ran == []
    assert out.out == ""
    assert "needs 1 CUDA card" in out.err


def test_entry_on_a_missing_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from benchmark.harness import cells, entry
    from benchmark.tests import support
    c = cells.resolve(support.REPO, "k8m3-encode-4m")
    with pytest.raises(RuntimeError):
        entry.build(support.REPO, c.config, c.traffic, torch.device("cuda"),
                    1)

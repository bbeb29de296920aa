"""Each cell once on the card, a short window (`-m cuda`; skips
without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests import support

BENCH = json.loads((support.REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=support.REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"

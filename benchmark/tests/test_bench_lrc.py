"""The LRC repair cell at CPU sizes: the entry is correct, the control
and a fault underneath the harness are not, and the helper-rows reader
reads 3.0 after a run and nothing without the program's counter."""

from __future__ import annotations

import json
import types

import pytest

from benchmark.harness import cells, loop
from benchmark.tests import support
from ceph_tpu_torch.ec.plugins import ec_lrc
from ceph_tpu_torch.ops import bitsliced as bs

CELL = "tiny-lrc"
READER = "helper_rows_per_rebuilt.repair"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The checkout's benchmark files plus the LRC configuration at
    objects of 32 KiB (chunks of 8 KiB) as a new cell."""
    root = support.make_root(tmp_path_factory.mktemp("lrc"), cells=())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark" / "configs"
                      / "ec-lrc-k4m2l3-4m.json").read_text())
    cfg.update(name=f"{CELL}-cfg", object_bytes=32768, shard_bytes=8192)
    cfg_file = f"benchmark/configs/{CELL}-cfg.json"
    (root / cfg_file).write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark" / "traffic"
                          / "lrc-repair-4m.json").read_text())
    traffic.update(objects_per_call=4, object_bytes=32768)
    (root / "benchmark" / "traffic" / f"{CELL}.json").write_text(
        json.dumps(traffic))
    bench["configs"].append({"name": f"{CELL}-cfg", "source": "test",
                             "file": cfg_file, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": f"{CELL}-cfg",
                               "traffic": CELL, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lrc-repair-4m" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_entry_is_correct(root, seed):
    res = support.run_small(root, CELL, seed=seed)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["rebuilt_bytes_wrong"] == {"value": 0, "limit": 0}
    assert set(res["metrics"]) == {"repair_GBps", "call_p95_ms", "setup_s"}


def test_control_is_not_correct(root):
    res = support.run_small(root, CELL, control=True)
    assert res["correct"] is False
    assert res["checks"]["rebuilt_bytes_wrong"]["value"] > 0


def test_fault_is_not_correct(root, monkeypatch):
    """One byte of each rebuilt chunk altered where K1 writes it."""
    real = bs.gf_bitmatmul

    def altered(*args, **kw):
        out = real(*args, **kw)
        out[0, -1] ^= 1
        return out
    monkeypatch.setattr(bs, "gf_bitmatmul", altered)
    res = support.run_small(root, CELL)
    assert res["correct"] is False
    assert res["failed"] > 0


def test_reader_after_a_run(root):
    ec_lrc.reset_local_repair_counts()
    res = support.run_small(root, CELL, trace=True)
    assert res["correct"] is True
    assert res["metrics"][READER] == {"value": 3.0, "unit": "rows"}
    counts = ec_lrc.local_repair_counts()
    # one plan lookup an apply, one rebuilt row an apply
    assert counts["plans_built"] + counts["plan_hits"] == \
        counts["rebuilt_rows"] > 0
    assert counts["plans_built"] == 8


def test_reader_reads_nothing_without_the_counter(monkeypatch):
    read = cells.load_reader(support.REPO, READER)
    ctx = types.SimpleNamespace(window=loop.Window(calls=10), trace=None,
                                least_traced_s=None)
    ec_lrc.reset_local_repair_counts()
    assert read(ctx, READER) is None               # no repair counted
    monkeypatch.delattr(ec_lrc, "local_repair_counts")
    assert read(ctx, READER) is None               # a program without it

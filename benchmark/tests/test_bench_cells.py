"""BENCHMARK.json against the files it names, and a cell added from new
files alone."""

from __future__ import annotations

import json
import re
import time

import pytest
import torch

from benchmark.harness import cells, runner
from benchmark.tests import support

BENCH = json.loads((support.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
E2E = {"encode_GBps", "repair_GBps", "call_p95_ms", "setup_s"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_metrics():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} == E2E
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        assert m["name"].split(".")[-1] in ("encode", "repair")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = cells.resolve(support.REPO, cell)
    assert c.chips == 1
    assert c.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["entry"] in ("encode", "repair", "clay_repair")
    assert {"setup_s", "call_p95_ms"} <= {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) == 3
    assert c.per_layer
    moves = {m["moves"] for m in c.per_layer}
    assert moves <= {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert cells.reader_path(support.REPO, m["name"]).exists()
        assert callable(cells.load_reader(support.REPO, m["name"]))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((support.REPO / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"] == []
    assert "assumed" in data and data["source"] == cfg["source"]
    assert data["object_bytes"] == data["k"] * data["shard_bytes"]


def test_new_cell_from_files_alone(tmp_path):
    """A cell added as a config, a traffic file and entries resolves
    and runs on the CPU, end-to-end metrics and per-layer ones."""
    root = support.make_root(tmp_path, ["tiny-encode"])
    c = cells.resolve(root, "tiny-encode")
    assert c.traffic["objects_per_call"] == 4
    res = support.run_small(root, "tiny-encode")
    assert res["correct"] is True
    assert set(res["metrics"]) == {"encode_GBps", "call_p95_ms", "setup_s"}
    assert res["device"]["platform"] == "cpu"
    traced = support.run_small(root, "tiny-encode", trace=True)
    assert traced["correct"] is True
    # no trace of a card and no launch counted on the CPU: the host's
    # own span is the one per-layer metric there is to read
    assert set(traced["metrics"]) == {"dispatch_us.encode"}
    assert list(res)[-1] == "checks"


NEW_ENTRY = '''
"""A later entry: K1's plain encode through the codec's device entry."""
from benchmark.harness import roofline
from benchmark.harness.entry import Entry, codec
from benchmark.reference import gf256


class K1Encode(Entry):
    metric = "encode_GBps"

    def setup(self):
        self.codec = codec(self.cfg, self.device)
        self.data = self._random(self.k, self.objects * self.shard)

    def work_bytes(self):
        return self.objects * self.object_bytes

    def cost(self):
        return roofline.apply_cost(self.m, self.k, self.objects * self.shard)

    def shapes(self):
        return [0]

    def warm_call(self, shape):
        return self.call(shape)

    def call(self, i):
        return self.codec.encode_chunks_device(self.data)

    def check(self, samples):
        gen = gf256.field(self.poly).generator(self.technique, self.k,
                                               self.m)
        want = gf256.apply(self.poly, gen[self.k:], self.data)
        wrong = [int((out != want).sum()) for out in samples]
        return ({"parity_bytes_wrong": (sum(wrong), 0)},
                sum(int(w > 0) for w in wrong))


ENTRY = K1Encode
'''


def test_new_entry_from_a_file_alone(tmp_path):
    """A cell whose traffic names an entry that only a new file under
    benchmark/entries/ defines: found by name, run, checked."""
    root = support.make_root(tmp_path, ["tiny-encode"])
    (root / "benchmark" / "entries" / "k1_encode_device.py").write_text(
        NEW_ENTRY)
    path = root / "benchmark" / "traffic" / "tiny-encode.json"
    traffic = json.loads(path.read_text())
    path.write_text(json.dumps({**traffic, "entry": "k1_encode"}))
    res = support.run_small(root, "tiny-encode")
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["parity_bytes_wrong"] == {"value": 0, "limit": 0}
    path.write_text(json.dumps({**traffic, "entry": "k9_encode"}))
    with pytest.raises(ValueError, match="k9_encode_device.py"):
        support.run_small(root, "tiny-encode")


def test_setup_leaves_out_the_reference(tmp_path):
    """setup_s leaves out the seconds the reference spends making a
    repair cell's inputs, and the run prints them as their own stage."""
    root = support.make_root(tmp_path, ["tiny-repair", "tiny-encode"])
    for cell, made_by_reference in (("tiny-repair", True),
                                    ("tiny-encode", False)):
        lines = []
        res = runner.run_cell(root, cell, 5, 0.3, False, torch.device("cpu"),
                              time.time(), log=lines.append)
        stages = dict(kv.split("=") for kv in next(
            ln for ln in lines if ln.startswith("setup_stages")).split()[1:])
        ref = float(stages["reference"])
        assert (ref > 0) == made_by_reference
        setup = res["metrics"]["setup_s"]["value"]
        assert abs(setup - (float(stages["warm"]) - ref)) < 2e-3


def test_technique_not_implemented_is_refused(tmp_path):
    """A configuration whose technique the reference does not implement
    is refused at set-up, never checked against another code."""
    root = support.make_root(tmp_path, ["tiny-repair"])
    path = root / "benchmark" / "configs" / "tiny-repair-cfg.json"
    cfg = json.loads(path.read_text())
    cfg["profile"]["technique"] = "liberation"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="liberation"):
        support.run_small(root, "tiny-repair")


def test_host_source_from_data_alone(tmp_path):
    """The traffic file's `source` picks the entry's staging: the same
    encode from pageable host memory through the launch queue, as data
    alone, correct on the CPU; its control is refused."""
    root = support.make_root(tmp_path, ["tiny-host"])
    res = support.run_small(root, "tiny-host")
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["crcs_wrong"]["value"] == 0
    with pytest.raises(ValueError, match="control"):
        support.run_small(root, "tiny-host", control=True)

"""The readers of host_prep_us.* and host_launch_us.* on a fake window
and fake stage counters."""

from __future__ import annotations

import json
import types

import pytest

from benchmark.harness import cells, loop
from benchmark.tests import support
from ceph_tpu_torch.ops import bitsliced as bs

METRICS = {"host_prep_us.encode": "prep_ns", "host_prep_us.repair": "prep_ns",
           "host_launch_us.encode": "launch_ns",
           "host_launch_us.repair": "launch_ns"}


def _ctx(traced_calls: int):
    return types.SimpleNamespace(
        window=loop.Window(calls=100, traced_calls=traced_calls),
        trace=None, least_traced_s=None)


def _stages(**by_wrapper):
    out = {name: {"calls": 0, "prep_ns": 0, "launch_ns": 0}
           for name in bs.launch_counts()}
    for name, (calls, prep, launch) in by_wrapper.items():
        out[name] = {"calls": calls, "prep_ns": prep, "launch_ns": launch}
    return out


@pytest.mark.parametrize("metric", list(METRICS))
def test_per_call_microseconds(metric, monkeypatch):
    monkeypatch.setattr(bs, "launch_stages", lambda: _stages(
        fused_hier_acc_call=(40, 1_200_000, 600_000),
        gf_bitmatmul=(10, 300_000, 100_000)))
    read = cells.load_reader(support.REPO, metric)
    want = {"prep_ns": 1_500_000, "launch_ns": 700_000}[METRICS[metric]]
    assert read(_ctx(50), metric) == pytest.approx(want / 50 / 1e3)


@pytest.mark.parametrize("metric", list(METRICS))
def test_nothing_to_read(metric, monkeypatch):
    read = cells.load_reader(support.REPO, metric)
    monkeypatch.setattr(bs, "launch_stages",
                        lambda: _stages(gf_bitmatmul=(3, 9_000, 3_000)))
    assert read(_ctx(0), metric) is None          # no traced calls
    monkeypatch.setattr(bs, "launch_stages", _stages)
    assert read(_ctx(50), metric) is None         # no armed launch
    monkeypatch.delattr(bs, "launch_stages")
    assert read(_ctx(50), metric) is None         # a program without them


def test_entries_name_their_readers():
    bench = json.loads((support.REPO / "BENCHMARK.json").read_text())
    names = {m["name"]: m for m in bench["per_layer"]}
    for metric in METRICS:
        m = names[metric]
        assert m["source"] == "program_counter" and m["unit"] == "us"
        assert cells.reader_path(support.REPO, metric).exists()

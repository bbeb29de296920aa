"""A cell of BENCHMARK.json, resolved from its name to its files.

A configuration is the JSON file its entry names; a traffic mix is
`benchmark/traffic/<traffic>.json`, whose `entry` and `source` name the
timed entry `benchmark/entries/<entry>_<source>.py` (harness/entry.py);
a per-layer metric's reader is `benchmark/metrics/<name>.py`, or
`benchmark/metrics/<base>.py` for a name `<base>.<suffix>`, which
serves every suffix.  Nothing here knows a cell by name: a new cell is
new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = "benchmark"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def _by_name(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def resolve(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _by_name(bench["workloads"], workload, "workload")
    c = _by_name(bench["configs"], w["config"], "config")
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads(
        (root / BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, config, traffic, int(w["chips"]), e2e, per_layer)


def reader_path(root: Path, metric: str) -> Path:
    """The file that reads a per-layer metric: its own, else its
    base name's."""
    d = Path(root) / BENCH_DIR / "metrics"
    own = d / f"{metric}.py"
    if own.exists():
        return own
    return d / f"{metric.split('.', 1)[0]}.py"


def load_module(path: Path, prefix: str):
    """The module of a file found by name (a reader, an entry)."""
    mod_name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: Path, metric: str):
    """The `read(ctx, name)` function of a metric's reader."""
    path = reader_path(root, metric)
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r}"
                                f" ({path})")
    return load_module(path, "benchmark_metric_").read

"""The benchmark of ceph_tpu_torch's erasure-code plane on one card.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line.  `harness/` is the measurement, `reference/` the plain NumPy and
PyTorch reference that decides `correct`, and `configs/`, `traffic/`
and `metrics/` hold what belongs to one configuration, one traffic mix
and one per-layer metric, each found by its name.
"""

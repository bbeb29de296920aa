"""The port's load harness (tools/load_harness.py) against the JAX
package's: tests/test_load_harness.py replayed on the port (its 12
tier-1 cases and its 2 `slow` ones, the cluster and the many-PG sweep
on the CPU), the virtual-time QoS sims and the CLI's line equal key for
key across packages, the per-stage quantiles of equal seeded dumps
equal across packages, the degraded-read scenario at scripts/tier1.sh's
size meeting the reference's gate, and the sharded bucket-index sweep's
reshard leg audited exactly."""

import contextlib
import io
import json

import numpy as np
import pytest

import ceph_tpu.tools.load_harness as jlh
import ceph_tpu_torch.tools.load_harness as tlh
from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, run_case)

HARNESS = ported("test_load_harness", subs=[
    ("run_ec_pg_sweep(pg_counts=(1, 4), total_objs=16,",
     'run_ec_pg_sweep(device="cpu", pg_counts=(1, 4), total_objs=16,'),
    ("run_qos_cluster_tenants(n_osds=4, clients=3,",
     'run_qos_cluster_tenants(device="cpu", n_osds=4, clients=3,')])

SLOW = ("test_qos_cluster_tenant_isolation_slow",
        "test_harness_cli_all_sim_scenarios_slow")


@pytest.mark.parametrize("case", [c for c in cases(HARNESS)
                                  if c not in SLOW])
def test_load_harness_replay(case):
    run_case(HARNESS, case)


@pytest.mark.slow
@pytest.mark.parametrize("case", SLOW)
def test_load_harness_slow_replay(case):
    run_case(HARNESS, case)


def test_replay_covers_the_reference_cases():
    assert len(cases(HARNESS)) == 14
    assert set(SLOW) <= set(cases(HARNESS))


# -- the sims and the CLI across packages ------------------------------------

@pytest.mark.parametrize("scenario", ["tenant", "recovery"])
def test_qos_sim_rows_equal_across_packages(scenario):
    """Virtual time and a seed: the rows are equal key for key."""
    got, want = (tlh.run_qos_isolation_sim(scenario),
                 jlh.run_qos_isolation_sim(scenario))
    assert got == want
    assert list(got) == list(want)
    assert got["isolated"] is True


def _cli_lines(main, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [ln for ln in buf.getvalue().splitlines() if ln.strip()]


@pytest.mark.parametrize("scenario", ["qos-sim", "qos-sim-recovery"])
def test_cli_sim_line_equal_across_packages(scenario):
    """The sims run no cluster: the port's default device is not asked
    for, and the printed line is the reference's, byte for byte."""
    argv = ["--scenario", scenario]
    got, want = _cli_lines(tlh.main, argv), _cli_lines(jlh.main, argv)
    assert got == want and len(got) == 1
    assert json.loads(got[0])["isolated"] is True


# -- per-stage quantiles across packages -------------------------------------

def _seeded_dumps(perf_cls, seed: int) -> list[dict]:
    """Three daemons' `perf dump`s with seeded stage samples (lognormal
    around 1-20 ms, plus the device-plane series), each from its own
    package's PerfCountersBuilder."""
    rng = np.random.default_rng(seed)
    dumps = []
    for d in range(3):
        name = f"optracker.osd.{d}"
        pc = perf_cls(name).create_perf_counters()
        for stage in ("commit", "queued", "sub_write_ack",
                      "ec_batch_wait", "launch_device"):
            n = int(rng.integers(1, 200))
            for s in rng.lognormal(np.log(0.004), 1.0, n):
                pc.hinc(f"lat_{stage}", float(s))
        dumps.append({name: pc.dump()})
    return dumps


def test_stage_quantiles_equal_across_packages():
    from ceph_tpu.common.perf_counters import PerfCountersBuilder as JB
    from ceph_tpu_torch.common.perf_counters import \
        PerfCountersBuilder as TB
    tdumps, jdumps = _seeded_dumps(TB, 11), _seeded_dumps(JB, 11)
    merged = tlh.merge_stage_histograms(tdumps)
    assert merged == jlh.merge_stage_histograms(jdumps)
    assert set(merged) == {"commit", "queued", "sub_write_ack",
                           "ec_batch_wait", "launch_device"}
    for unit_ms in (True, False):
        got = tlh.stage_quantiles(tdumps, unit_ms=unit_ms)
        assert got == jlh.stage_quantiles(jdumps, unit_ms=unit_ms)
    assert all(row["count"] > 0 for row in got.values())


# -- the degraded-read scenario and the bucket-index sweep on the CPU ---------

def test_degraded_read_gate_at_tier1_size():
    """scripts/tier1.sh's degraded-read run (12 OSDs, 5 x 16 KiB) on a
    CPU cluster: the reference's gate, unchanged."""
    row = tlh.run_degraded_read_storm(n_osds=12, objects=5, size=16384,
                                      device="cpu")
    assert row["ok"] is True, row
    assert row["zero_acked_loss"] is True
    assert row["mismatches"] == 0 and row["unreadable"] == 0
    assert row["reconstruct_reads"] >= 1
    assert row["objects_acked"] >= 1
    json.dumps(row)


def test_s3_shard_sweep_reshard_audit_is_exact():
    """The sweep at a small size, its wall-clock legs (ingest speedup,
    listing p99 and flatness) ungated, as the reference's structural test
    leaves the PG sweep's fraction (min_frac=0.0):
    the online reshard 1 -> 8 under writers and an OSD kill/revive loses,
    adds, duplicates and misroutes no key."""
    row = tlh.run_s3_shard_sweep(shard_counts=(1, 8), keys=40, writers=2,
                                 passes=1, prefill=200, min_x=0.0,
                                 p99_max_ms=1e9, flat_factor=1e9,
                                 device="cpu")
    assert row["metric"] == "harness_s3_shard_sweep"
    audit = row["reshard"]
    assert (audit["lost"], audit["extra"], audit["duplicated"],
            audit["misrouted"]) == (0, 0, 0, 0), audit
    assert audit["shards"] == 8
    assert row["reshard_ok"] is True
    assert row["ingest_ok"] and row["list_ok"] and row["ok"]
    json.dumps(row)


def test_default_device_is_the_card():
    """Every entry that builds a cluster or a backend asks for the card
    by default, and raises without one instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlh.run_many_pg_write(1, 1, 4096)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlh.main(["--scenario", "rados", "--osds", "3", "--seconds",
                  "0.1"])

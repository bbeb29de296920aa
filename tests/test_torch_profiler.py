"""The port's device-plane flight recorder (ops/profiler.py) against
tests/test_profiler.py, replayed on the port: the launch ring, the
disabled fast path through a real backend, compile attribution and the
storm window, trace stitching through the launch queue, the heartbeat
tick-lag detector, the mon's COMPILE_STORM check and the exporter's
launch-latency gauges, and the asok round trip with the per-stage blame
of tools/load_harness on a live cluster.  Its backends run the torch
plugin on the CPU where the reference's run the jax plugin."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

PROFILER = ported("test_profiler", subs=[
    ('def make_backend(pg, queue, plugin="jax"',
     'def make_backend(pg, queue, plugin="torch"'),
    ('    if plugin == "jax":\n        prof["technique"] = "cauchy"',
     '    if plugin == "torch":\n        prof["technique"] = "cauchy"\n'
     '        prof["device"] = "cpu"'),
    ("ECLaunchQueue(window_us=", 'ECLaunchQueue(device="cpu", window_us='),
    # a first-seen bucket is a compile on the port only when its submit
    # builds the kernel library (or an injected stall stands in for the
    # build): the cases' compile is the injection
    ('    r1 = p.begin("fused_encode")\n'
     '    time.sleep(0.08)                          # "the compile"\n',
     '    p.inject_stall_s = 0.08                   # "the compile"\n'
     '    r1 = p.begin("fused_encode")\n'),
    ("    host.stall_s = 0.0          # every first bucket marks the blame",
     "    host.stall_s = 0.0          # every first bucket marks the blame\n"
     "    host.inject_stall_s = 0.001")])


@pytest.mark.parametrize("case", [
    "test_launch_ring_eviction_and_monotonic_ids",
    "test_profiler_off_null_fast_path",
    "test_compile_first_bucket_vs_warm_relaunch",
    "test_injected_stall_feeds_storm_window",
    "test_trace_stitching_depth2_pipelined_batch",
    "test_hb_tick_lag_detector_with_injected_stall",
    "test_hb_tick_lag_unit", "test_compile_storm_health_check",
    "test_exporter_emits_lat_launch_percentile_gauges",
    "test_cluster_asok_roundtrip_and_stage_blame"])
def test_profiler_replay(case, tmp_path):
    run_case(PROFILER, case, tmp_path=tmp_path)

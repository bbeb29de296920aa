"""The percentile pipeline and the wire-plane flight recorder on the
port: tests/test_percentiles.py (histogram quantiles, `dump_latencies`
and its asok, the exporter's percentile gauges) and
tests/test_msgr_ledger.py (the messenger ledger, reactor lag, dispatch
waits, run_sync timeouts, the reactor pool, slow sends on an op's
timeline, the MSGR_REACTOR_LAG check, the cluster's asok, exporter and
health round trip, a stalled EC op that names the wire) replayed on the
port, its EC pool on torch on the CPU.  The wire-kill case
(test_reconnect_and_replay_counted_across_wire_kill) is a reference
flake under load and stays out."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

PERCENTILES = ported("test_percentiles")
MSGR_LEDGER = ported("test_msgr_ledger")


@pytest.mark.parametrize("case", [
    "test_quantile_uniform_in_one_bucket",
    "test_quantile_known_two_bucket_split",
    "test_quantile_exact_bucket_boundary",
    "test_quantile_inf_bucket",
    "test_quantile_empty_histogram",
    "test_quantile_rejects_bad_q",
    "test_quantile_error_bounds_contain_truth",
    "test_dump_latencies_summary_shape",
    "test_dump_latencies_collection_and_asok",
    "test_percentiles_from_samples_exact",
    "test_dinc_auto_creates_u64",
    "test_exporter_emits_percentile_gauges",
    "test_histogram_axis_covers_default_buckets"])
def test_percentiles_replay(case):
    run_case(PERCENTILES, case)


@pytest.mark.parametrize("case", [
    "test_disabled_null_path_records_nothing",
    "test_per_type_counters_and_peer_ring_bound",
    "test_reactor_lag_probe_event_rule_and_window",
    "test_dispatch_wait_histograms_under_blocked_dispatcher",
    "test_run_sync_timeout_conf_and_counted",
    "test_configure_pool_sizes_reactors",
    "test_slow_send_names_peer_on_op_timeline",
    "test_msgr_reactor_lag_health_unit",
    "test_cluster_asok_exporter_and_health_roundtrip",
    "test_cluster_injected_stall_slow_op_names_wire"])
def test_msgr_ledger_replay(case, tmp_path):
    run_case(MSGR_LEDGER, case, tmp_path=tmp_path)

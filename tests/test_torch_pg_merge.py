"""Live PG merging on a port cluster on the CPU: tests/test_pg_merge.py's
cluster cases replayed on the port (the `pg_num` decrease and its guard,
a replicated merge, a stale client retargeted from a dying child to its
parent, `ok-to-stop` below min_size, drain / safe-to-destroy / rm,
the mgr's pg autoscaler shrinking a pool that opted in).  The `slow`
cases stay out of tier 1."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

MERGE = ported("test_pg_merge")


@pytest.mark.parametrize("case", [
    "test_pg_num_decrease_validation_guard_and_pg_stat",
    "test_replicated_merge_smoke_16_to_8",
    "test_stale_client_retargets_dying_child_to_parent",
    "test_ok_to_stop_refuses_below_min_size",
    "test_drain_safe_to_destroy_rm_no_window_below_min_size"])
def test_pg_merge_replay(case):
    run_case(MERGE, case)


def test_autoscaler_replay():
    run_case(MERGE, "test_autoscaler_scales_down_with_optin")

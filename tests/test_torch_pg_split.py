"""Live PG splitting on a port cluster on the CPU: tests/test_pg_split.py's
cluster cases replayed on the port (the mon's `pg_num` commands and
their validation, objects moved into child PGs and read, an EC split
scrubbed clean, a client op in flight retargeted to its child), the EC
case on the reference's jerasure pool and on a torch one, and the mgr's
pg autoscaler growing a pool that opted in; the `slow` cases stay out
of tier 1."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

SPLIT = ported("test_pg_split")
SPLIT_TORCH = ported("test_pg_split", subs=[
    ('"plugin": "jerasure"', '"plugin": "torch"')])


@pytest.mark.parametrize("case", [
    "test_pg_num_validation_and_override_pruning",
    "test_replicated_split_objects_move_and_read",
    "test_inflight_client_op_retargets_to_child"])
def test_pg_split_replay(case):
    run_case(SPLIT, case)


@pytest.mark.parametrize("mod", [SPLIT, SPLIT_TORCH],
                         ids=["jerasure", "torch"])
def test_ec_split_replay(mod):
    run_case(mod, "test_ec_split_objects_read_and_scrub_clean")


def test_autoscaler_replay():
    run_case(SPLIT, "test_autoscaler_acts_only_with_optin")

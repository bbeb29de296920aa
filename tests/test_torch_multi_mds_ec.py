"""tests/test_multi_mds.py replayed on the port as in
tests/test_torch_multi_mds.py, with `cephfs_data` an erasure pool of
torch k=4 m=2 (a file of its own, so that each file's cases stay short
under the tier-1 run's load)."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, run_case)
from test_torch_multi_mds import CASES, MULTI, multi_env


@pytest.fixture()
def env():
    yield from multi_env("ec")


@pytest.mark.parametrize("case", CASES)
def test_multi_mds_replay_on_an_ec_data_pool(env, case):
    run_case(MULTI, case, env=env)

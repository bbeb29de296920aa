"""tests/test_rgw_policy.py replayed on the port: bucket policies
(validation, evaluation, Deny over Allow over the ACL) and presigned
URLs through a port gateway on a port cluster on the CPU."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

POLICY = ported("test_rgw_policy")
# the reference's own fixtures, on the port
env = POLICY.env


@pytest.mark.parametrize("case", cases(POLICY))
def test_rgw_policy_replay(case, request):
    replay(POLICY, case, request)

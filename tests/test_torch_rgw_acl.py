"""tests/test_rgw_acl.py replayed on the port: canned ACLs on buckets
and objects, anonymous and authenticated readers, the acl
subresource, through a port gateway on a port cluster on the CPU."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

ACL = ported("test_rgw_acl")
# the reference's own fixtures, on the port
env = ACL.env


@pytest.mark.parametrize("case", cases(ACL))
def test_rgw_acl_replay(case, request):
    replay(ACL, case, request)

"""tests/test_rgw_quota.py replayed on the port: user stats, quotas
through cls_user reservations, the usage log, ownership moves and
version surgery on an RGWStore of a port cluster on the CPU."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

QUOTA = ported("test_rgw_quota")
# the reference's own fixtures, on the port
store = QUOTA.store


@pytest.mark.parametrize("case", cases(QUOTA))
def test_rgw_quota_replay(case, request):
    replay(QUOTA, case, request)

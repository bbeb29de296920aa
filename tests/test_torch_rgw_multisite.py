"""tests/test_rgw_multisite.py replayed on the port: two port clusters
on the CPU as two zones, mod-log replay with checkpoints, full sync,
versioned buckets and multipart objects arriving as one object."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

SITE = ported("test_rgw_multisite")
# the reference's own fixtures, on the port
zones = SITE.zones


@pytest.mark.parametrize("case", cases(SITE))
def test_rgw_multisite_replay(case, request):
    replay(SITE, case, request)

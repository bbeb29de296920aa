"""tests/test_rgw_lifecycle.py replayed on the port: lifecycle
configurations over S3, expiry by prefix and day, stale multipart
aborts, expired delete markers and the gateway's worker thread."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

LC = ported("test_rgw_lifecycle")
# the reference's own fixtures, on the port
env = LC.env


@pytest.mark.parametrize("case", cases(LC))
def test_rgw_lifecycle_replay(case, request):
    replay(LC, case, request)

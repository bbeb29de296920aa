"""tests/test_rgw_notify.py replayed on the port: topics, bucket
bindings with event and prefix filters, and at-least-once delivery
to a local HTTP receiver that goes down and comes back."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

NOTIFY = ported("test_rgw_notify")
# the reference's own fixtures, on the port
env = NOTIFY.env


@pytest.mark.parametrize("case", cases(NOTIFY))
def test_rgw_notify_replay(case, request):
    replay(NOTIFY, case, request)

"""tests/test_swift.py replayed on the port: /auth/v1.0 tokens,
containers and objects under /swift/v1 and the same objects through
S3, on a port gateway over a port cluster on the CPU."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

SWIFT = ported("test_swift")
# the reference's own fixtures, on the port
gw, base, tok = SWIFT.gw, SWIFT.base, SWIFT.tok


@pytest.mark.parametrize("case", cases(SWIFT))
def test_swift_replay(case, request):
    replay(SWIFT, case, request)

"""tests/test_rgw.py replayed on the port: buckets, objects, listings
with delimiters and pages, SigV4 (headers, streaming bodies),
multipart uploads, versioning and server-side copies through a port
gateway whose data pool is the reference's jerasure k=2 m=1, on a
port cluster on the CPU (tests/test_torch_rgw_ec.py runs the same
cases on a torch data pool)."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

RGW = ported("test_rgw")
# the reference's own fixtures, on the port
gw, s3 = RGW.gw, RGW.s3


@pytest.mark.parametrize("case", cases(RGW))
def test_rgw_replay(case, request):
    replay(RGW, case, request)

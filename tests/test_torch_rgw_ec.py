"""tests/test_rgw.py replayed on the port with the gateway's data pool
on the port's own codec: torch k=4 m=2 (cauchy, 1 KiB stripe unit,
6 OSDs), so every object PUT, part, version and copy is encoded by
the `torch` plugin's plain versions on the CPU."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

RGW = ported("test_rgw", subs=[
    ('Cluster(device="cpu", n_osds=4)',
     'Cluster(device="cpu", n_osds=6)'),
    ('"plugin": "jerasure", "k": "2", "m": "1",',
     '"plugin": "torch", "k": "4", "m": "2", "technique": "cauchy",')])
# the reference's own fixtures, on the port
gw, s3 = RGW.gw, RGW.s3


@pytest.mark.parametrize("case", cases(RGW))
def test_rgw_ec_replay(case, request):
    replay(RGW, case, request)

"""Peering on a port cluster on the CPU: tests/test_peering.py's cluster
cases replayed on the port (acked writes survive a primary failover, a
divergent shard is rolled back, incomplete peering refuses ops and
touches nothing, the PG meta object is hidden from listings), on the
reference's jerasure pool and on a torch one.  The file's backend-level
cases are replayed in tests/test_torch_pg_log.py."""

import pytest

from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

PEERING = ported("test_peering")


@pytest.fixture(scope="module", params=["jerasure", "torch"])
def fcluster(request):
    """The reference's fcluster (6 OSDs, an EC pool k=2 m=1), its pool
    on `request.param`."""
    with Cluster(n_osds=6, device="cpu") as c:
        client = c.client()
        client.set_ec_profile("peer_p", {
            "plugin": request.param, "k": "2", "m": "1",
            "stripe_unit": "1024"})
        client.create_pool("peerpool", "erasure",
                           erasure_code_profile="peer_p", pg_num=4)
        yield c, client


@pytest.mark.parametrize("case", [
    "test_acked_writes_survive_primary_failover",
    "test_divergent_shard_rolled_back_on_peering",
    "test_incomplete_peering_refuses_ops_and_touches_nothing",
    "test_meta_object_hidden_from_listing"])
def test_peering_replay(fcluster, case):
    run_case(PEERING, case, fcluster=fcluster)

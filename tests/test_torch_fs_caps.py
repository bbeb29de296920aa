"""CephFS capabilities and the mdlog on a port cluster on the CPU:
tests/test_fs_caps.py replayed on the port (the cache cap, its revoke
and return, the stat lease, a dead holder, a renamed directory's cached
stats, and a restart that replays a half-applied rename or unlink), on
a replicated data pool and on a torch k=4 m=2 erasure one."""

import pytest

from ceph_tpu_torch.fs import MDSDaemon
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)
from test_torch_fs import DATA_POOLS, fs_cluster

CAPS = ported("test_fs_caps")


@pytest.fixture(scope="module", params=DATA_POOLS)
def cluster(request):
    """The reference's cluster fixture (3 OSDs, one MDS) on
    `request.param`'s data pool."""
    with fs_cluster(3, request.param) as c:
        mds = MDSDaemon(c.mon_addrs[0])
        yield c, mds
        mds.shutdown()


@pytest.mark.parametrize("case", [
    "test_sole_opener_gets_cache_cap",
    "test_contending_clients_revoke_grant",
    "test_cache_cap_returns_when_sole_again",
    "test_stat_lease_cache",
    "test_dead_holder_does_not_block_open",
    "test_rename_dir_evicts_descendant_stat_cache",
    "test_mdlog_replays_half_applied_rename",
    "test_mdlog_replays_half_applied_unlink"])
def test_fs_caps_replay(cluster, case):
    run_case(CAPS, case, cluster=cluster)

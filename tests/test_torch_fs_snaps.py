"""CephFS snapshots on a port cluster on the CPU: tests/test_fs_snaps.py
replayed on the port (a snapshot keeps a subtree's bytes and names,
its views are read-only, another client's writes copy on write, the
`.snap` directory, `snap_rm`, snapshots across an MDS restart), on a
replicated data pool and on a torch k=4 m=2 erasure one, where each
copy-on-write is a clone of every shard."""

import pytest

from ceph_tpu_torch.fs import CephFS, MDSDaemon
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)
from test_torch_fs import DATA_POOLS, fs_cluster

SNAPS = ported("test_fs_snaps")


@pytest.fixture(scope="module", params=DATA_POOLS)
def fs_env(request):
    """The reference's fs_env (3 OSDs) on `request.param`'s data pool."""
    with fs_cluster(3, request.param) as c:
        mds = MDSDaemon(c.mon_addrs[0])
        fs = CephFS(c.mon_addrs[0], mds.addr, name="snapc1")
        yield c, mds, fs
        fs.shutdown()
        mds.shutdown()


@pytest.mark.parametrize("case", [
    "test_snapshot_preserves_data_and_namespace",
    "test_snapshot_views_are_read_only",
    "test_second_client_writes_cow_after_snap",
    "test_dot_snap_virtual_dir_lists_snapshots",
    "test_snap_rm",
    "test_snapshots_survive_mds_restart"])
def test_fs_snaps_replay(fs_env, case):
    run_case(SNAPS, case, fs_env=fs_env)

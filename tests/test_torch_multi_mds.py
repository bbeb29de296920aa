"""Multi-MDS on a port cluster on the CPU: tests/test_multi_mds.py
replayed on the port (a subtree exported to rank b with redirects, an
open file across the migration, creates and renames across a frozen
boundary, the donor's crash mid-migration, a rank's failover, and a
takeover refused while the peer lives), on a replicated data pool and
on a torch k=4 m=2 erasure one (tests/test_torch_multi_mds_ec.py).
The reference's timeouts stand."""

import pytest

from ceph_tpu_torch.fs import CephFS, MDSDaemon
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)
from test_torch_fs import fs_cluster

MULTI = ported("test_multi_mds")


def multi_env(data_pool: str):
    """The reference's env (3 OSDs, ranks a and b, max_mds 2) on
    `data_pool`."""
    with fs_cluster(3, data_pool) as c:
        mds_a = MDSDaemon(c.mon_addrs, name="a")
        c.client().mon_command({"prefix": "fs set max_mds",
                                "name": "cephfs", "max_mds": "2"})
        mds_b = MDSDaemon(c.mon_addrs, name="b")
        fs = CephFS(c.mon_addrs, mds_a.addr)
        yield c, mds_a, mds_b, fs
        fs.shutdown()
        mds_a.shutdown()
        mds_b.shutdown()


@pytest.fixture()
def env():
    yield from multi_env("replicated")


CASES = [
    "test_export_moves_authority_and_redirects",
    "test_open_file_survives_migration",
    "test_boundary_ops_during_migration",
    "test_donor_crash_mid_migration_recovers",
    "test_rank_failover_takeover",
    "test_takeover_refuses_live_peer"]


@pytest.mark.parametrize("case", CASES)
def test_multi_mds_replay(env, case):
    run_case(MULTI, case, env=env)

"""Self-managed RADOS snapshots on a port cluster on the CPU:
tests/test_snaps.py's cluster cases replayed on the port (copy-on-write
clones, reads at a snap, read-only snaps, delete and recreate, the snap
trimmer, and RBD's snapshots, clones and rollback over them), on the
reference's jerasure EC pool and on a torch one."""

import pytest

from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

SNAPS = ported("test_snaps")


@pytest.fixture(scope="module", params=["jerasure", "torch"])
def snapenv(request):
    """The reference's snapenv (an EC pool `snap_ec`, k=2 m=1, and a
    replicated `snap_rep`), its EC pool on `request.param`."""
    with Cluster(n_osds=4, device="cpu") as c:
        client = c.client()
        client.set_ec_profile("sp", {"plugin": request.param, "k": "2",
                                     "m": "1", "stripe_unit": "1024"})
        client.create_pool("snap_ec", "erasure",
                           erasure_code_profile="sp", pg_num=4)
        client.create_pool("snap_rep", "replicated", size=2, pg_num=4)
        yield c, client


@pytest.mark.parametrize("case,pool", [
    ("test_cow_and_snap_reads", "snap_ec"),
    ("test_cow_and_snap_reads", "snap_rep"),
    ("test_object_born_after_snap_is_absent_at_snap", "snap_ec"),
    ("test_object_born_after_snap_is_absent_at_snap", "snap_rep"),
    ("test_snap_objects_are_read_only", None),
    ("test_unsnapped_pool_unaffected", None),
    ("test_rbd_cow_snapshots_and_clone", None),
    ("test_rbd_rollback_after_multiple_snaps", None),
    ("test_delete_recreate_keeps_snap_history", "snap_ec"),
    ("test_delete_recreate_keeps_snap_history", "snap_rep"),
    ("test_snap_trim_reclaims_clones", None)])
def test_snaps_replay(snapenv, case, pool):
    run_case(SNAPS, case, snapenv=snapenv, pool=pool)

"""The port's RBD exclusive lock, object map and journal
(rbd/exclusive_lock.py, rbd/object_map.py, rbd/journal.py) on port
clusters on the CPU: tests/test_rbd_lock.py and tests/test_rbd_mirror.py
replayed on the port.  Both put their images on replicated pools, as
the reference does: an EC pool answers omap ops with EOPNOTSUPP, and
the lock, the object map and the journal live in omap."""

import pytest

from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

LOCK = ported("test_rbd_lock")
MIRROR = ported("test_rbd_mirror")


@pytest.fixture(scope="module")
def cluster():
    with Cluster(n_osds=3, device="cpu") as c:
        client = c.client()
        client.create_pool("rbdlk", "replicated", pg_num=4)
        yield c, client


@pytest.mark.parametrize("case", [
    "test_second_writer_blocked", "test_steal_fences_old_owner",
    "test_dead_owner_lock_broken", "test_object_map_du_and_persistence",
    "test_lockless_write_invalidates_map",
    "test_object_map_with_clone_copyup", "test_cross_client_lock_respected",
    "test_lockless_write_blocked_by_live_owner",
    "test_closed_handle_rejects_writes",
    "test_fenced_reads_bypass_stale_map",
    "test_fenced_handle_cannot_corrupt_journal",
    "test_blacklist_fences_in_flight_op"])
def test_rbd_lock_replay(cluster, case):
    run_case(LOCK, case, cluster=cluster)


@pytest.fixture(scope="module")
def env():
    with Cluster(n_osds=4, device="cpu") as c:
        client = c.client()
        client.create_pool("primary", "replicated", size=2, pg_num=4)
        client.create_pool("backup", "replicated", size=2, pg_num=4)
        yield (c, client,
               client.open_ioctx("primary"),
               client.open_ioctx("backup"))


@pytest.mark.parametrize("case", [
    "test_journaling_records_before_apply",
    "test_append_crash_window_never_wedges_replay",
    "test_mirror_replays_and_is_incremental",
    "test_mirror_replays_snapshots_and_resize", "test_journal_trim"])
def test_rbd_mirror_replay(env, case):
    run_case(MIRROR, case, env=env)

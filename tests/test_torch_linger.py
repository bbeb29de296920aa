"""Watches that linger across failures and the journal object class on
a port cluster on the CPU: tests/test_linger.py (a watch survives its
primary's death and an OSD restart, unwatch stops the re-assertion)
and tests/test_cls_journal.py (appends, client positions, trim fenced
by the slowest client) replayed on the port."""

import pytest

from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

LINGER = ported("test_linger")
JOURNAL = ported("test_cls_journal")


@pytest.fixture(scope="module")
def cluster():
    with Cluster(n_osds=5, device="cpu") as c:
        cl = c.client()
        cl.create_pool(LINGER.POOL, pg_num=8, size=3)
        yield c


@pytest.mark.parametrize("case", [
    "test_watch_survives_primary_death",
    "test_watch_survives_osd_restart_same_primary",
    "test_unwatch_stops_reassertion"])
def test_linger_replay(cluster, case):
    run_case(LINGER, case, cluster=cluster)


@pytest.fixture(scope="module")
def io():
    with Cluster(n_osds=2, device="cpu") as c:
        client = c.client()
        client.create_pool("jp", pg_num=4, size=2)
        yield client.open_ioctx("jp")


@pytest.mark.parametrize("case", [
    "test_append_seq_and_list", "test_client_positions_monotonic",
    "test_trim_fenced_by_slowest_client"])
def test_cls_journal_replay(io, case):
    run_case(JOURNAL, case, io=io)

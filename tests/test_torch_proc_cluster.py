"""The port's process cluster on the CPU over FileStore: a mon and OSD
daemons, each its own OS process (`python -m
ceph_tpu_torch.tools.daemon_main ... --device cpu`), one module-scoped
cluster.  tests/test_proc_cluster.py's I/O and SIGKILL cases replay on
a `torch` EC pool; a cold restart SIGKILLs every daemon, the mon too,
and brings the cluster back from its data dirs with every acked write
intact.  tests/test_torch_proc_cluster_blue.py runs the same on
BlueStore."""

import numpy as np
import pytest

from ceph_tpu_torch.common.admin_socket import admin_command
from ceph_tpu_torch.tools.proc_cluster import ProcCluster
from test_torch_cluster_foundations import ported, run_case

PROFILE = {"plugin": "torch", "k": "2", "m": "2", "technique": "cauchy",
           "stripe_unit": "1024"}
EC_POOL = ('client.set_ec_profile("{0}p", {1!r}); '
           'client.create_pool("{0}", "erasure", '
           'erasure_code_profile="{0}p", pg_num=8)')

# omap is not served by an EC pool (EOPNOTSUPP, as Ceph's): the basic
# case's omap step moves to a replicated pool beside its EC one
PROC = ported("test_proc_cluster", subs=[
    ('client.create_pool("procpool", pg_num=8, size=3)',
     EC_POOL.format("procpool", PROFILE)),
    ('io.omap_set("obj", {b"k": b"v"})\n'
     '    assert io.omap_get_vals("obj") == {b"k": b"v"}',
     'client.create_pool("procrep", pg_num=8, size=3)\n'
     '    rio = client.open_ioctx("procrep")\n'
     '    rio.omap_set("obj", {b"k": b"v"})\n'
     '    assert rio.omap_get_vals("obj") == {b"k": b"v"}'),
    ('client.create_pool("durpool", pg_num=8, size=3)',
     EC_POOL.format("durpool", PROFILE))])


REPLAYED = ["test_basic_io_across_processes",
            "test_sigkill_revive_durability"]


def proc_cluster(objectstore, tmp_path_factory):
    """A 5-OSD process cluster on the CPU over `objectstore`, its data
    and admin sockets in pytest's temporary directories."""
    root = tmp_path_factory.mktemp(objectstore)
    asok = tmp_path_factory.mktemp("asok")
    with ProcCluster(n_osds=5, objectstore=objectstore,
                     heartbeat_interval=0.25, device="cpu",
                     data_dir=str(root / "data"), asok_dir=str(asok)) as c:
        yield c


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    yield from proc_cluster("filestore", tmp_path_factory)


@pytest.mark.parametrize("case", REPLAYED)
def test_proc_cluster_replay(cluster, case):
    run_case(PROC, case, cluster=cluster)


def test_cold_restart_keeps_every_acked_write(cluster):
    cold_restart_case(cluster)


def cold_restart_case(cluster):
    """Writes (whole objects, an overwrite) with one OSD SIGKILLed and
    revived, then a SIGKILL of every daemon: the cluster restarts from
    its stores, reaches active+clean and reads back every acked byte;
    a deep scrub through the admin sockets finds nothing.  The
    overwrite lands while the OSD is down; when that OSD held the
    object's shard, peering rebuilds its stale copy."""
    client = cluster.client()
    name = f"cold{cluster.objectstore}"
    client.set_ec_profile(f"{name}p", PROFILE)
    client.create_pool(name, "erasure", erasure_code_profile=f"{name}p",
                       pg_num=8)
    io = client.open_ioctx(name)
    rng = np.random.default_rng(7)
    want = {f"c{i}": rng.integers(0, 256, 5000 + 700 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(10)}
    for k, v in want.items():
        io.write_full(k, v)
    victim = client.objecter._calc_target(io.pool_id, "c0")[1]
    cluster.kill_osd(victim)
    cluster.mark_osd_down(victim)
    for i in range(10, 14):
        want[f"c{i}"] = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        io.write_full(f"c{i}", want[f"c{i}"])
    patch = rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
    io.write("c3", patch, offset=1000)
    want["c3"] = want["c3"][:1000] + patch + want["c3"][1600:]
    cluster.revive_osd(victim)
    cluster.wait_active_clean(timeout=120)
    for k, v in want.items():
        assert io.read(k, len(v)) == v, k

    cluster.kill_all()
    times = cluster.restart_all()
    assert times["up_s"] < cluster.boot_timeout
    cluster.wait_active_clean(timeout=120)
    io = cluster.client().open_ioctx(name)
    for k, v in want.items():
        assert io.read(k, len(v)) == v, k
    errors = scrubbed = 0
    for i in range(cluster.n_osds):
        res = admin_command(cluster.asok_path(f"osd.{i}"),
                            {"prefix": "scrub", "deep": True}, timeout=60)
        assert "error" not in res, res
        for r in res.values():
            errors += len(r["errors"])
            scrubbed += r["objects"]
    assert errors == 0
    assert scrubbed >= len(want)
    profile = admin_command(cluster.asok_path("osd.0"),
                            {"prefix": "launch profile"})
    # the plain versions ran: no kernel launched on the CPU
    assert set(profile["kernel_launches"].values()) == {0}

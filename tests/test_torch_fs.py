"""CephFS on a port cluster on the CPU: tests/test_fs.py replayed on the
port (namespace ops, file blocks across the block size, a second client,
the namespace across an MDS restart, unlinked blocks purged, renames),
with the reference's replicated data pool and again with an erasure
data pool of torch k=4 m=2 (`cephfs_data` made before the MDS boots,
which then keeps it, as a CephFS on an EC pool is set up)."""

import contextlib

import pytest

from ceph_tpu_torch.fs import CephFS, MDSDaemon
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

FS = ported("test_fs")

# the erasure data pool of the second pass: torch k=4 m=2
EC_PROFILE = {"plugin": "torch", "k": "4", "m": "2", "technique": "cauchy",
              "stripe_unit": "4096"}
DATA_POOLS = ["replicated", "ec"]


@contextlib.contextmanager
def fs_cluster(n_osds: int, data_pool: str, **kw):
    """A port cluster on the CPU for a CephFS: with `data_pool` "ec",
    `cephfs_data` is an erasure pool of EC_PROFILE (k+m OSDs at least),
    made before any MDS boots; "replicated" leaves the pools to the
    MDS, as the reference's tests do."""
    if data_pool == "ec":
        n_osds = max(n_osds, 6)
    with Cluster(n_osds=n_osds, device="cpu", **kw) as c:
        if data_pool == "ec":
            cl = c.client()
            cl.set_ec_profile("fsdata", EC_PROFILE)
            cl.create_pool("cephfs_data", "erasure",
                           erasure_code_profile="fsdata", pg_num=8)
        yield c


@pytest.fixture(scope="module", params=DATA_POOLS)
def fsenv(request):
    """The reference's fsenv (4 OSDs, 8 KiB blocks) on `request.param`'s
    data pool."""
    with fs_cluster(4, request.param) as c:
        mds = MDSDaemon(c.mon_addrs, block_size=FS.BS)
        fs = CephFS(c.mon_addrs, mds.addr)
        yield c, mds, fs
        fs.shutdown()
        mds.shutdown()


@pytest.mark.parametrize("case", [
    "test_mkdir_readdir_stat",
    "test_file_write_read_across_blocks",
    "test_append_and_truncate",
    "test_rename_unlink_rmdir",
    "test_second_client_sees_everything",
    "test_namespace_survives_mds_restart",
    "test_unlink_purges_data_blocks",
    "test_same_dir_rename_and_rename_over_existing"])
def test_fs_replay(fsenv, case):
    run_case(FS, case, fsenv=fsenv)


def test_data_pool_is_the_mds_data_pool(fsenv, request):
    """The MDS kept the data pool made before it booted (an erasure
    pool on the "ec" pass), and a file's blocks land there."""
    c, _, fs = fsenv
    pools = {p.name: p for p in c.mon.osdmap.pools.values()}
    data = pools["cephfs_data"]
    assert fs.data.pool_id == data.id
    assert not pools["cephfs_metadata"].is_erasure()
    ec = request.node.callspec.params["fsenv"] == "ec"
    assert data.is_erasure() == ec
    assert data.erasure_code_profile == ("fsdata" if ec else "")
    fs.write_file("/in_data_pool", b"d" * (FS.BS + 1))
    ino = fs.stat("/in_data_pool")["ino"]
    from ceph_tpu_torch.fs.mds import data_oid
    assert fs.data.read(data_oid(ino, 1), 1) == b"d"

"""The file service as a whole, on the CPU: chip_smoke.py's phase O file
traffic (`fs_sequence`: directories, whole-block files and small files,
overwrites, a truncate, a rename, unlinks, a snapshot with overwrites
under it, a second client, the OSD of data shard 1 of the first file's
first block down and back, an MDS restart) at a small size, through a
reference cluster (`plugin=jax`) and a port cluster (`plugin=torch` on
the CPU), each with its own package's MDS in process and an erasure
data pool of k=4 m=2.  The port must read back every byte written, and
the namespaces and the data pool's shards, OSD by OSD, must be equal but
where the reference's fault shows: an overwrite that ends inside a
stripe zeroes the rest of that stripe in ceph_tpu (ROADMAP Queue 3 item
7), and the test records exactly those bytes.  Also: a directory tree
written by one package's MDS opens in the other's, and the port's `mds`
daemon role in a process cluster survives a SIGKILL."""

import numpy as np
import pytest

import chip_smoke
from ceph_tpu.fs import CephFS as JCephFS
from ceph_tpu.fs import MDSDaemon as JMDS
from ceph_tpu.tools.vstart import Cluster as JCluster
from ceph_tpu_torch.fs import CephFS as TCephFS
from ceph_tpu_torch.fs import MDSDaemon as TMDS
from ceph_tpu_torch.fs.mds import data_oid
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster import shard_state
from test_torch_cluster_foundations import port_singletons  # noqa: F401

# phase O at 64 KiB blocks, each step over a quarter of the files it
# covers on the card or fewer; each overwrite is two stripes long, as
# on the card (64 KiB at 8 x 4 KiB stripes there)
BLOCK = 64 << 10
SIZES = {"dirs": 4, "big": (4, 4 * BLOCK), "small": (12, 16 << 10),
         "overwrites": (4, 32 << 10), "unlinks": 3}
PROFILE = {"k": "4", "m": "2", "technique": "cauchy", "stripe_unit": "4096"}
STRIPE = 4 * 4096
N_OSDS = 7


def _data_pool(c, plugin, profile=PROFILE):
    cl = c.client()
    cl.set_ec_profile("fsdata", dict(profile, plugin=plugin))
    cl.create_pool("cephfs_data", "erasure", erasure_code_profile="fsdata",
                   pg_num=8)


def _run(c, plugin, fs_cls, mds_cls, check):
    """fs_sequence on `c` with its package's in-process MDS; returns its
    result, the step labels and each file's inode."""
    _data_pool(c, plugin)
    mds = [mds_cls(c.mon_addrs, name="a", block_size=BLOCK)]
    clients = []

    def mount(addr=None):
        fs = fs_cls(c.mon_addrs, addr or mds[-1].addr,
                    name=f"fsc{len(clients)}")
        clients.append(fs)
        return fs

    def restart_mds():
        mds[-1].shutdown()
        mds.append(mds_cls(c.mon_addrs, name="a", block_size=BLOCK))
        return mds[-1].addr

    steps = []
    try:
        res = chip_smoke.fs_sequence(
            mount(), mount, c, lambda osd: None, restart_mds, SIZES,
            lambda label, fn, nbytes, ops=0: (fn(), steps.append(label)),
            check=check)
        inos = {p: clients[-1].stat(p)["ino"] for p in res["namespace"]}
    finally:
        for fs in clients:
            fs.shutdown()
        mds[-1].shutdown()
    return res, steps, inos


def _tails(overwrites):
    """{path: [(start, end)]}: the bytes after each overwrite up to the
    end of its stripe, which the reference's fault zeroes."""
    out = {}
    for p, off, n in overwrites:
        end = off + n
        out.setdefault(p, []).append((end, -(-end // STRIPE) * STRIPE))
    return out


def test_file_service_stores_what_the_reference_stores():
    wrong = {}

    def record(got, want, what):
        g = np.frombuffer(got, dtype=np.uint8)
        if g.size != want.size or not np.array_equal(g, want):
            wrong.setdefault(what.split(": ", 1)[1], []).append(
                (what, g, want))

    with JCluster(n_osds=N_OSDS) as jc, \
            Cluster(n_osds=N_OSDS, device="cpu") as tc:
        tres, tsteps, tinos = _run(tc, "torch", TCephFS, TMDS,
                                   chip_smoke.check_bytes)
        jres, jsteps, jinos = _run(jc, "jax", JCephFS, JMDS, record)
        assert tsteps == jsteps and len(tsteps) == 17
        assert tres["namespace"] == jres["namespace"]
        assert len(tres["namespace"]) == 4 + 1 + 4 + 12 - 3
        assert tinos == jinos
        assert tres["victim"] == jres["victim"]
        assert tres["overwrites"] == jres["overwrites"]
        # the reference's reads differ only in the tail stripes of the
        # overwrites, where it reads zeros
        tails = _tails(tres["overwrites"])
        hit = set()
        for path, reads in wrong.items():
            head = path.replace("/.snap/s1", "")
            for what, g, want in reads:
                assert g.size == want.size, what
                bad = np.flatnonzero(g != want)
                assert not g[bad].any(), what
                for x in bad:
                    span = next(((s, e) for s, e in tails[head]
                                 if s <= x < e), None)
                    assert span is not None, (what, int(x))
                    hit.add((head, int(x) // BLOCK))
        assert hit, "the reference's tail-stripe fault did not show"
        # the port's sha256s are the bytes written; the reference's
        # differ exactly in the files it zeroed
        differ = {p for p in tres["sha256"]
                  if tres["sha256"][p] != jres["sha256"][p]}
        assert differ == set(wrong) & set(tres["sha256"])
        # the data pool's shards, OSD by OSD: equal but in the objects of
        # the blocks the reference zeroed
        zeroed = {data_oid(tinos[p], b) for p, b in hit}
        n = 0
        for j_osd, t_osd in zip(jc.osds, tc.osds):
            js, ts = shard_state(j_osd.store), shard_state(t_osd.store)
            assert set(ts) == set(js), t_osd.osd_id
            for key in ts:
                if any(z in key[1] for z in zeroed):
                    continue
                assert ts[key] == js[key], (t_osd.osd_id, key)
                n += 1
        assert n >= (4 * 4 + 9) * 6 // 2


PACKAGES = {"jax": (JCluster, {}, JCephFS, JMDS),
            "torch": (Cluster, {"device": "cpu"}, TCephFS, TMDS)}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_tree_opens_in_the_other_package(tmp_path, writer, reader):
    """A tree (directories, files across blocks, a snapshot with a file
    overwritten under it) written through one package's MDS on BlueStore
    opens, with the same pools and mon data dir, in the other package's
    MDS, and reads back equal.  Its data pool is jerasure k=4 m=2, a
    plugin both packages have (each package's card plugin is unknown to
    the other's OSDs)."""
    rng = np.random.default_rng(23)
    files = {f"/t/d{i % 2}/f{i}": rng.integers(
        0, 256, int(rng.integers(1, 3 * BLOCK)), dtype=np.uint8).tobytes()
        for i in range(6)}
    d = str(tmp_path / "c")
    cls, kw, fs_cls, mds_cls = PACKAGES[writer]
    with cls(n_osds=6, objectstore="bluestore", data_dir=d, **kw) as c:
        _data_pool(c, "jerasure", {"k": "4", "m": "2",
                                   "stripe_unit": "4096"})
        mds = mds_cls(c.mon_addrs, block_size=BLOCK)
        fs = fs_cls(c.mon_addrs, mds.addr)
        for p, v in files.items():
            fs.makedirs(p.rsplit("/", 1)[0])
            fs.write_file(p, v)
        fs.snap_create("/t", "s")
        fs.write_file("/t/d0/f0", b"after the snapshot")
        ns = chip_smoke.fs_namespace(fs)
        fs.shutdown()
        mds.shutdown()
    cls, kw, fs_cls, mds_cls = PACKAGES[reader]
    with cls(n_osds=6, objectstore="bluestore", data_dir=d, **kw) as c:
        c.wait_active_clean(timeout=120)
        mds = mds_cls(c.mon_addrs, block_size=BLOCK)
        fs = fs_cls(c.mon_addrs, mds.addr)
        try:
            assert chip_smoke.fs_namespace(fs) == ns
            assert fs.snap_list("/t") == ["s"]
            for p, v in files.items():
                assert fs.read_file("/t/.snap/s" + p[2:]) == v, p
                assert fs.read_file(p) == (b"after the snapshot"
                                           if p == "/t/d0/f0" else v), p
        finally:
            fs.shutdown()
            mds.shutdown()


def test_process_mds_survives_sigkill(tmp_path):
    """The `mds` role of daemon_main through ProcCluster.spawn_mds: a
    client writes and reads a file on a torch EC data pool, the MDS is
    SIGKILLed and spawned again under its name, and a fresh client sees
    the namespace and the bytes."""
    from ceph_tpu_torch.tools.proc_cluster import ProcCluster
    blob = np.random.default_rng(29).integers(
        0, 256, (4 << 20) + 4321, dtype=np.uint8).tobytes()
    with ProcCluster(n_osds=6, objectstore="bluestore", device="cpu",
                     data_dir=str(tmp_path / "d"),
                     heartbeat_interval=0.0) as c:
        _data_pool(c, "torch")
        addr = c.spawn_mds("a")
        fs = TCephFS(c.mon_addrs, addr)
        try:
            fs.makedirs("/p/q")
            fs.write_file("/p/q/blob", blob)
            assert fs.read_file("/p/q/blob") == blob
            assert fs.stat("/p/q/blob")["size"] == len(blob)
            ns = chip_smoke.fs_namespace(fs)
        finally:
            fs.shutdown()
        proc = c.mds_procs["a"]
        c.kill_mds("a")
        assert proc.returncode == -9
        addr = c.spawn_mds("a")
        fs = TCephFS(c.mon_addrs, addr, name="after")
        try:
            assert chip_smoke.fs_namespace(fs) == ns
            assert fs.read_file("/p/q/blob") == blob
            r, dump = fs.rados.mon_command({"prefix": "fs dump"})
            assert r == 0 and dump["filesystems"]["cephfs"]["mds"]["a"][
                "addr"] == list(addr)
        finally:
            fs.shutdown()
    assert (tmp_path / "d" / "mds.a.log").exists()

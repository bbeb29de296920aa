"""The block service as a whole, on the CPU: chip_smoke.py's phase N op
sequence (`rbd_sequence`: images, `rbd bench`, a snapshot with writes
under it, export-diff and import-diff, a clone with copyups, a striped
object, an export with an OSD down and after its revive) at a small
size, through a reference cluster (`plugin=jax`) and a port cluster
(`plugin=torch` on the CPU), each driven through its own package's
`rbd` and `rados` CLIs.  Every export, the diff streams and the striped
object must be equal, and so must every OSD's shards and HashInfos."""

import contextlib
import io as _io

import chip_smoke
import ceph_tpu.rbd as jrbd
import ceph_tpu_torch.rbd as trbd
from ceph_tpu.rados.striper import StripedObject as JStriped
from ceph_tpu.tools import rados_cli as jrados_cli
from ceph_tpu.tools import rbd_cli as jrbd_cli
from ceph_tpu.tools.vstart import Cluster as JCluster
from ceph_tpu_torch.rados.striper import StripedObject as TStriped
from ceph_tpu_torch.tools import rados_cli as trados_cli
from ceph_tpu_torch.tools import rbd_cli as trbd_cli
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster import shard_state
from test_torch_cluster_foundations import port_singletons  # noqa: F401

# phase N at order 16 (64 KiB objects), each step over a quarter of the
# objects it covers on the card or fewer
SIZES = {"order": 16, "image": 2 << 20, "import": 1 << 20,
         "bench_big": (64 << 10, 1 << 20), "bench_small": (4096, 64 << 10),
         "snap_writes": (16, 16 << 10), "child_writes": (16, 4096),
         "striper": (1 << 20, 64 << 10, 1, 64 << 10)}
PROFILE = {"k": "4", "m": "2", "technique": "cauchy", "stripe_unit": "4096"}
N_OSDS = 7


def _run(pkg, c, tools, rbd_mod, striper_cls, root):
    cl = c.client()
    cl.set_ec_profile("rbdp", dict(PROFILE, plugin=pkg))
    cl.create_pool("rbd", "erasure", erasure_code_profile="rbdp", pg_num=8)
    io = cl.open_ioctx("rbd")
    mon = "%s:%d" % tuple(c.mon.addr)

    def cli(tool, argv):
        out = _io.StringIO()
        with contextlib.redirect_stdout(out):
            assert tools[tool].main(["-m", mon, "-p", "rbd", *argv]) == 0
        return out.getvalue()

    steps = []
    root.mkdir()
    res = chip_smoke.rbd_sequence(
        io, cli, rbd_mod, striper_cls, c, lambda osd: None, root, SIZES,
        lambda label, fn, nbytes: (fn(), steps.append(label)))
    return res, steps, {f.name: f.read_bytes() for f in root.glob("*.diff")}


def test_block_service_stores_what_the_reference_stores(tmp_path):
    with JCluster(n_osds=N_OSDS) as jc, \
            Cluster(n_osds=N_OSDS, device="cpu") as tc:
        jres, jsteps, jdiffs = _run(
            "jax", jc, {"rbd_cli": jrbd_cli, "rados_cli": jrados_cli},
            jrbd, JStriped, tmp_path / "j")
        tres, tsteps, tdiffs = _run(
            "torch", tc, {"rbd_cli": trbd_cli, "rados_cli": trados_cli},
            trbd, TStriped, tmp_path / "t")
        assert tsteps == jsteps and len(tsteps) == 24
        # every export, both diff streams, the striped object
        assert tres["sha256"] == jres["sha256"]
        assert len(tres["sha256"]) == 10
        assert tdiffs == jdiffs and len(tdiffs) == 2
        assert tres["victim"] == jres["victim"]
        n = 0
        for j_osd, t_osd in zip(jc.osds, tc.osds):
            state = shard_state(t_osd.store)
            assert state == shard_state(j_osd.store), t_osd.osd_id
            n += len(state)
        # vol0's, vol1's, vol0s1's and the clone's objects, the snapshot
        # clones and the striped pieces, k+m shards each
        assert n >= (16 + 16 + 16 + 16 + 16) * 6

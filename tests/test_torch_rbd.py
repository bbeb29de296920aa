"""The port's striper (rados/striper.py) and RBD images (rbd/) on a port
cluster on the CPU: tests/test_services.py's striper, rbd and
watch-notify cases replayed on the port, on the reference's jerasure
pool and on a torch pool, and the module-level surface of `rbd` and
the striper against the JAX package's."""

import pytest

import ceph_tpu.rados.striper as jstriper
import ceph_tpu.rbd as jrbd
import ceph_tpu.rbd.image as jimage
import ceph_tpu_torch.rados.striper as tstriper
import ceph_tpu_torch.rbd as trbd
import ceph_tpu_torch.rbd.image as timage
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

SERVICES = ported("test_services")
PLUGINS = ["jerasure", "torch"]


@pytest.fixture(scope="module")
def cluster():
    with Cluster(n_osds=5, device="cpu") as c:
        yield c


@pytest.fixture(scope="module", params=PLUGINS)
def io(request, cluster):
    """The reference's `svc` pool (jerasure k=3 m=2) and the same pool
    on the port's torch plugin."""
    plugin = request.param
    client = cluster.client()
    client.set_ec_profile(f"sp_{plugin}",
                          {"plugin": plugin, "k": "3", "m": "2"})
    client.create_pool(f"svc_{plugin}", "erasure",
                       erasure_code_profile=f"sp_{plugin}", pg_num=8)
    return client.open_ioctx(f"svc_{plugin}")


@pytest.mark.parametrize("case", [
    "test_striper_roundtrip", "test_striper_overwrite_and_sparse",
    "test_rbd_create_write_read", "test_rbd_bounds_and_resize",
    "test_rbd_snapshots", "test_rbd_remove", "test_watch_notify"])
def test_services_replay(io, case):
    run_case(SERVICES, case, io=io)


def test_package_surface_matches_the_reference():
    """The same public names, defaults and object naming: an image or
    striped object written by either package is found by the other."""
    assert trbd.__all__ == jrbd.__all__
    assert timage.DEFAULT_ORDER == jimage.DEFAULT_ORDER == 22
    assert timage._header("img") == jimage._header("img")
    assert timage._data("img", 7) == jimage._data("img", 7)
    assert timage._legacy_snap_data("img", "s", 7) == \
        jimage._legacy_snap_data("img", "s", 7)
    assert (tstriper.SIZE_XATTR, tstriper.LAYOUT_XATTR) == \
        (jstriper.SIZE_XATTR, jstriper.LAYOUT_XATTR)

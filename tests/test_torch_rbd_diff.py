"""The port's export-diff / import-diff (rbd/diff.py) on port clusters on
the CPU: tests/test_rbd_diff.py replayed on the port (its CLI case
through the port's `rbd_cli`), and the stream format held against the
JAX package's: the same writes give the same stream bytes in both, and
a stream written by either package imports into the other's image."""

import io as _io

import numpy as np
import pytest

from ceph_tpu.rbd import RBD as JRBD
from ceph_tpu.rbd import Image as JImage
from ceph_tpu.tools.vstart import Cluster as JCluster
from ceph_tpu_torch.rbd import RBD, Image
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

DIFF = ported("test_rbd_diff")
MB = 1 << 20


@pytest.fixture(scope="module")
def cluster():
    with Cluster(n_osds=3, device="cpu") as c:
        client = c.client()
        client.create_pool("rbddiff", "replicated", pg_num=4)
        yield c, client


@pytest.mark.parametrize("case", [
    "test_diff_roundtrip_identical_checksum",
    "test_diff_of_unchanged_image_is_empty",
    "test_subblock_write_produces_tight_run", "test_zero_run_record",
    "test_import_diff_requires_base_snap", "test_diff_handles_resize",
    "test_cli_export_import_diff", "test_diff_handles_shrink"])
def test_rbd_diff_replay(cluster, case):
    run_case(DIFF, case, cluster=cluster)


@pytest.fixture(scope="module")
def both(cluster):
    """(RBD, Image, {pool kind: ioctx}) of a reference cluster and of the
    port's, each with a replicated pool and an EC pool of its own
    plugin."""
    with JCluster(n_osds=4) as jc:
        out = []
        for pkg, c, rbd, image in (("jax", jc, JRBD, JImage),
                                   ("torch", cluster[0], RBD, Image)):
            cl = c.client()
            cl.create_pool(f"dx_{pkg}", "replicated", size=2, pg_num=4)
            cl.set_ec_profile(f"dx_{pkg}", {"plugin": pkg, "k": "2",
                                            "m": "1",
                                            "stripe_unit": "1024"})
            cl.create_pool(f"dxec_{pkg}", "erasure",
                           erasure_code_profile=f"dx_{pkg}", pg_num=4)
            out.append((rbd, image, {
                "rep": cl.open_ioctx(f"dx_{pkg}"),
                "ec": cl.open_ioctx(f"dxec_{pkg}")}))
        yield out


ZEROED = (200_000, 5000)       # a run of zeros written between A and B


def _history(rbd, image, io, name):
    """The same writes, snapshots and resize in either package; returns
    the full stream up to A, the incremental A -> B, the head and the
    image at A."""
    rng = np.random.default_rng(16)
    rbd(io).create(name, 2 * MB, order=16)
    img = image(io, name)
    img.write(0, rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    img.snap_create("A")
    img.write(70_000, rng.integers(0, 256, 90_000,
                                   dtype=np.uint8).tobytes())
    img.write(ZEROED[0], b"\0" * ZEROED[1])
    img.resize(3 * MB)
    img.write(2 * MB + 777, b"tail" * 999)
    img.snap_create("B")
    full, inc = _io.BytesIO(), _io.BytesIO()
    img.export_diff(full, to_snap="A")
    img.export_diff(inc, from_snap="A", to_snap="B")
    head = img.read(0, img.size())
    img.snap_set("A")
    at_a = img.read(0, 2 * MB)
    img.close()
    return full.getvalue(), inc.getvalue(), head, at_a


def _expected() -> tuple[bytes, bytes]:
    """What _history's head and image at A must hold."""
    rng = np.random.default_rng(16)
    head = np.zeros(3 * MB, dtype=np.uint8)
    head[:300_000] = rng.integers(0, 256, 300_000, dtype=np.uint8)
    at_a = head[:2 * MB].tobytes()
    head[70_000:160_000] = rng.integers(0, 256, 90_000, dtype=np.uint8)
    head[ZEROED[0]:sum(ZEROED)] = 0
    head[2 * MB + 777:2 * MB + 777 + 3996] = np.frombuffer(
        b"tail" * 999, dtype=np.uint8)
    return head.tobytes(), at_a


def _replicate(rbd, image, io, name, full, inc) -> bytes:
    rbd(io).create(name, 2 * MB, order=16)
    dst = image(io, name)
    dst.import_diff(_io.BytesIO(full))
    assert dst.snap_list() == ["A"]
    stats = dst.import_diff(_io.BytesIO(inc))
    assert stats["w"] >= 1 and stats["z"] >= 1
    assert dst.snap_list() == ["A", "B"]
    head = dst.read(0, dst.size())
    dst.close()
    return head


def test_diff_streams_equal_and_cross_import(both):
    """On replicated pools: the same streams from both packages, and a
    stream written by either rebuilds the image in the other's
    cluster."""
    (jrbd, jimage, jio), (trbd, timage, tio) = both
    jfull, jinc, jhead, jat_a = _history(jrbd, jimage, jio["rep"], "hist")
    tfull, tinc, thead, tat_a = _history(trbd, timage, tio["rep"], "hist")
    assert (thead, tat_a) == _expected()
    assert (tfull, tinc, thead, tat_a) == (jfull, jinc, jhead, jat_a)
    assert _replicate(trbd, timage, tio["rep"], "replica", jfull,
                      jinc) == thead
    assert _replicate(jrbd, jimage, jio["rep"], "replica", tfull,
                      tinc) == thead


def test_diff_on_an_ec_pool_keeps_the_tail_stripe(both):
    """On EC pools (k=2, 2 KiB stripes) the run of zeros written after A
    is a read-modify-write whose tail stripe holds older bytes: the
    port keeps them, in its head and in its stream, and the stream
    rebuilds the image.  ceph_tpu's ECBackend writes zeros over the
    rest of that stripe (ROADMAP Queue 3 item 7), so its head and
    incremental stream differ from the port's there and only there."""
    (jrbd, jimage, jio), (trbd, timage, tio) = both
    want, want_a = _expected()
    tfull, tinc, thead, tat_a = _history(trbd, timage, tio["ec"], "hist")
    assert (thead, tat_a) == (want, want_a)
    assert _replicate(trbd, timage, tio["ec"], "replica", tfull,
                      tinc) == want
    jfull, jinc, jhead, jat_a = _history(jrbd, jimage, jio["ec"], "hist")
    assert (jfull, jat_a) == (tfull, tat_a)
    end = sum(ZEROED)
    stripe_end = -(-end // 2048) * 2048
    assert jhead[:end] + jhead[stripe_end:] == want[:end] + \
        want[stripe_end:]
    assert jhead[end:stripe_end] != want[end:stripe_end]
    assert jhead[end:stripe_end] == b"\0" * (stripe_end - end)

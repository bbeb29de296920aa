"""The port's persistent object stores against the JAX package's:
tests/test_blue_store.py (its cluster case on a CPU cluster),
tests/test_file_store.py,
test_services.py's objectstore-tool round trip and
test_generations.py's crash replay, replayed on the port; then the
on-disk formats held across packages — a FileStore or BlueStore (plain
and `-zlib`) directory written by either package, unmounted cleanly or
left as a crash leaves it, mounts in the other with the same object
lists, bytes, xattrs, omap and omap headers, and an objectstore-tool
export moves between the packages."""

import numpy as np
import pytest

import ceph_tpu.osd.types as jtypes
import ceph_tpu.store as jstore
import ceph_tpu.store.object_store as jos
import ceph_tpu.tools.objectstore_tool as jtool
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.store as tstore
import ceph_tpu_torch.store.object_store as tos
import ceph_tpu_torch.tools.objectstore_tool as ttool
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

ON_CPU = 'ECBackend(codec, StripeInfo({}), {}, device="cpu")'

BLUE = ported("test_blue_store")
FILE = ported("test_file_store", subs=[
    ("ECBackend(codec, StripeInfo(3 * 64, 64), shards)",
     ON_CPU.format("3 * 64, 64", "shards")),
    ("ECBackend(codec, StripeInfo(3 * 64, 64), shards2)",
     ON_CPU.format("3 * 64, 64", "shards2"))])
SERVICES = ported("test_services")
GENERATIONS = ported("test_generations", subs=[(
    "ECBackend(codec, StripeInfo(K * CHUNK, CHUNK), shards)",
    ON_CPU.format("K * CHUNK, CHUNK", "shards"))])


@pytest.mark.parametrize("case", [
    "test_allocator_first_fit_merge_release",
    "test_allocator_grows_on_demand",
    "test_allocator_mark_used_carves",
    "test_write_read_roundtrip",
    "test_persistence_across_mounts",
    "test_overwrite_releases_old_extents",
    "test_small_overwrite_is_deferred_in_place",
    "test_deferred_replay_after_crash",
    "test_deferred_then_read_same_txn",
    "test_failed_txn_releases_allocations",
    "test_bitrot_detected_at_rest",
    "test_compression_at_rest",
    "test_clone_and_rename",
    "test_allocator_rebuild_at_mount"])
def test_blue_store_replay(case, tmp_path):
    run_case(BLUE, case, tmp_path=tmp_path)


def test_cluster_runs_on_bluestore_replay(tmp_path):
    run_case(BLUE, "test_cluster_runs_on_bluestore", tmp_path=tmp_path)


@pytest.mark.parametrize("case", [
    "test_logdb_persistence",
    "test_logdb_compaction_preserves",
    "test_logdb_torn_wal_tail",
    "test_filestore_roundtrip_and_remount",
    "test_filestore_overwrite_truncate_remove",
    "test_filestore_journal_replay",
    "test_filestore_runs_ec_pipeline"])
def test_file_store_replay(case, tmp_path):
    run_case(FILE, case, tmp_path=tmp_path)


def test_objectstore_tool_roundtrip_replay(tmp_path, capsys):
    run_case(SERVICES, "test_objectstore_tool_roundtrip",
             tmp_path=tmp_path, capsys=capsys)


def test_overwrite_survives_crash_replay(tmp_path):
    run_case(GENERATIONS, "test_overwrite_survives_crash_replay",
             tmp_path=tmp_path)


def test_replays_run_on_the_port():
    import ceph_tpu_torch.store.blue_store as tblue
    import ceph_tpu_torch.store.file_store as tfile
    assert BLUE.BlueStore is tblue.BlueStore
    assert FILE.FileStore is tfile.FileStore
    assert GENERATIONS.FileStore is tfile.FileStore


# -- the same directories in both packages ------------------------------------

PKGS = {"jax": (jstore, jos, jtypes, jtool),
        "torch": (tstore, tos, ttypes, ttool)}
KINDS = ("filestore", "bluestore", "bluestore-zlib")


def workload(pkg: str, store, seed: int) -> None:
    """A seeded mix on two EC shard collections: whole-object writes
    (some larger than BlueStore's deferred limit, some compressible),
    small in-place overwrites (the deferred path), xattrs, omap keys and
    headers, omap removals, truncates, zeroes, clones, renames and a
    removal, one transaction per step as the OSD queues them."""
    _, os_, types, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    cids = [types.spg_t(types.pg_t(1, s), sh) for s, sh in ((0, 2), (5, 0))]

    def oid(cid, name):
        return types.ghobject_t(types.hobject_t(pool=1, name=name),
                                shard=cid.shard)

    def blob(n):
        # half the objects compress (a small alphabet), half do not
        hi = 4 if rng.random() < 0.5 else 256
        return rng.integers(0, hi, n, dtype=np.uint8)

    for cid in cids:
        store.create_collection(cid)
        for i in range(8):
            t = os_.Transaction()
            g = oid(cid, f"obj{i}")
            size = int(rng.choice([4096, 20_000, 70_000, 200_000]))
            t.write(g, 0, blob(size))
            t.setattrs(g, {"_": rng.bytes(20), "snapset": rng.bytes(9)})
            t.omap_setkeys(g, {rng.bytes(6): rng.bytes(30)
                               for _ in range(3)})
            t.omap_setheader(g, rng.bytes(5))
            store.queue_transactions(cid, [t])
        for i in range(8):
            g = oid(cid, f"obj{i}")
            t = os_.Transaction()
            off = int(rng.integers(0, 2048)) * 2
            t.write(g, off, blob(int(rng.choice([512, 8192, 65_536]))))
            t.setattr(g, "chunk_crc", rng.bytes(4))
            store.queue_transactions(cid, [t])
        t = os_.Transaction()
        t.truncate(oid(cid, "obj1"), 3000)
        t.zero(oid(cid, "obj2"), 100, 2000)
        t.clone(oid(cid, "obj3"), oid(cid, "obj3.clone"))
        t.rename(oid(cid, "obj4"), oid(cid, "obj4.renamed"))
        t.remove(oid(cid, "obj5"))
        t.omap_rmkeys(oid(cid, "obj6"),
                      list(store.omap_get(cid, oid(cid, "obj6")))[:1])
        t.rmattr(oid(cid, "obj7"), "snapset")
        store.queue_transactions(cid, [t])


def dump(store, headers: bool = True) -> dict:
    """Everything a reader sees, keyed by the objects' printed names
    (without omap headers where `headers` is False: the export format
    does not carry them)."""
    out = {}
    for cid in store.list_collections():
        objs = {}
        for g in store.list_objects(cid):
            objs[str(g)] = (bytes(store.read(cid, g)), store.stat(cid, g),
                            store.getattrs(cid, g), store.omap_get(cid, g),
                            store.omap_get_header(cid, g) if headers
                            else None)
        out[str(cid)] = objs
    return out


@pytest.mark.parametrize("crash", [False, True], ids=["umount", "crash"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", KINDS)
def test_store_directory_mounts_in_the_other_package(tmp_path, kind, writer,
                                                     crash):
    reader = "torch" if writer == "jax" else "jax"
    path = str(tmp_path / "store")
    w = PKGS[writer][0].create_store(kind, path)
    w.mount()
    workload(writer, w, seed=17)
    want = dump(w)
    assert sum(len(objs) for objs in want.values()) == 2 * 8
    if not crash:
        w.umount()
    r = PKGS[reader][0].create_store(kind, path)
    r.mount()
    assert dump(r) == want
    r.umount()


@pytest.mark.parametrize("kind", KINDS)
def test_same_workload_reads_the_same(tmp_path, kind):
    """The same transactions in both packages' stores read back the
    same, before and after a remount."""
    dumps = {}
    for pkg in PKGS:
        path = str(tmp_path / pkg)
        s = PKGS[pkg][0].create_store(kind, path)
        s.mount()
        workload(pkg, s, seed=23)
        dumps[pkg] = dump(s)
        s.umount()
        s = PKGS[pkg][0].create_store(kind, path)
        s.mount()
        assert dump(s) == dumps[pkg]
        s.umount()
    assert dumps["torch"] == dumps["jax"]


@pytest.mark.parametrize("exporter", ["jax", "torch"])
def test_export_imports_into_the_other_package(tmp_path, exporter,
                                               capsys):
    """An export of one PG shard by one package's tool is the other's
    byte for byte, and imports through the other package's tool into a
    fresh store with the same contents."""
    importer = "torch" if exporter == "jax" else "jax"
    path = str(tmp_path / "osd0")
    s = PKGS[exporter][0].create_store("filestore", path)
    s.mount()
    workload(exporter, s, seed=29)
    want = dump(s, headers=False)
    s.umount()
    exports = {}
    for pkg in PKGS:
        exports[pkg] = str(tmp_path / f"pg.{pkg}.export")
        assert PKGS[pkg][3].main(["--data-path", path, "--op", "export",
                                  "--pgid", "1.0s2", "--file",
                                  exports[pkg]]) == 0
    capsys.readouterr()
    with open(exports["jax"], "rb") as fj, open(exports["torch"], "rb") as ft:
        assert fj.read() == ft.read()
    path2 = str(tmp_path / "osd1")
    s2 = PKGS[importer][0].create_store("filestore", path2)
    s2.mount()
    s2.umount()
    assert PKGS[importer][3].main(["--data-path", path2, "--op", "import",
                                   "--file", exports[exporter]]) == 0
    assert "imported 8 objects into 1.0s2" in capsys.readouterr().out
    s3 = PKGS[importer][0].create_store("filestore", path2)
    s3.mount()
    got = dump(s3, headers=False)
    s3.umount()
    assert got == {"1.0s2": want["1.0s2"]}


@pytest.mark.parametrize("kind", ["bluestore", "bluestore-zlib"])
def test_objectstore_tool_on_bluestore(tmp_path, kind, capsys):
    """The port's tool takes `--type` for a BlueStore: list, dump and
    remove on one, and its export imports into a FileStore."""
    path = str(tmp_path / "osd0")
    s = tstore.create_store(kind, path)
    s.mount()
    workload("torch", s, seed=31)
    want = dump(s, headers=False)
    s.umount()
    base = ["--data-path", path, "--type", kind]
    assert ttool.main(base + ["--op", "list-pgs"]) == 0
    assert capsys.readouterr().out.split() == sorted(want)
    assert ttool.main(base + ["--op", "dump", "--pgid", "1.5s0",
                              "obj0"]) == 0
    assert '"oid": "obj0"' in capsys.readouterr().out
    exp = str(tmp_path / "pg.export")
    assert ttool.main(base + ["--op", "export", "--pgid", "1.5s0",
                              "--file", exp]) == 0
    assert ttool.main(base + ["--op", "remove", "--pgid", "1.5s0",
                              "obj0"]) == 0
    capsys.readouterr()
    fs = str(tmp_path / "osd1")
    assert ttool.main(["--data-path", fs, "--op", "import",
                       "--file", exp]) == 0
    s2 = tstore.create_store("filestore", fs)
    s2.mount()
    assert dump(s2, headers=False) == {"1.5s0": want["1.5s0"]}
    s2.umount()
    s3 = tstore.create_store(kind, path)
    s3.mount()
    assert "obj0" not in {g.hobj.name for g in s3.list_objects(
        ttypes.spg_t(ttypes.pg_t(1, 5), 0))}
    s3.umount()

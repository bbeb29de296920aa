"""The port's LSM kv engine (store/kv_lsm.py) and `open_kv` against the
JAX package's: tests/test_kv_lsm.py's cases replayed on the port, and
the on-disk format held across packages — a directory written by either
package's LsmDB opens in the other with the same contents, and the same
batch sequence writes the same WAL, SST and manifest bytes."""

import os
import random
from pathlib import Path

import pytest

import ceph_tpu.store.kv as jkv
import ceph_tpu.store.kv_lsm as jlsm
import ceph_tpu_torch.store.kv as tkv
import ceph_tpu_torch.store.kv_lsm as tlsm
from test_torch_cluster_foundations import ported, run_case

KV_LSM = ported("test_kv_lsm")


@pytest.mark.parametrize("case", [
    "test_basic_roundtrip",
    "test_batch_atomic_and_replay",
    "test_torn_wal_tail",
    "test_flush_and_sst_reads",
    "test_shadowing_across_levels",
    "test_leveled_compaction_is_bounded",
    "test_multi_level_structure_forms",
    "test_range_iterator",
    "test_prefix_iterate_ff_edge",
    "test_iterator_survives_compaction",
    "test_retired_readers_close_deterministically",
    "test_abandoned_iterator_releases_pins",
    "test_close_sweeps_parked_readers",
    "test_crash_mid_compaction_orphan_gc",
    "test_crash_after_flush_before_wal_truncate",
    "test_torn_tail_then_acked_write_survives",
    "test_logdb_migration",
    "test_open_kv_factory",
    "test_soak_100k_keys_flat_latency"])
def test_kv_lsm_replay(case, tmp_path):
    run_case(KV_LSM, case, tmp_path=tmp_path)


def test_replay_runs_on_the_port():
    """The replayed module's engine is the port's."""
    assert KV_LSM.LsmDB is tlsm.LsmDB
    assert KV_LSM.open_kv is tkv.open_kv


SMALL = dict(memtable_bytes=4096, l0_max_files=3, base_level_bytes=16384,
             level_multiplier=4, block_size=512, target_file_bytes=4096)


def drive(lsm, kv, path, seed: int, n: int = 1500, close: bool = True):
    """A seeded batch sequence (sets, deletes, multi-op batches and one
    full compaction) on one package's LsmDB; returns the db's contents
    (the db is left open, unflushed, when `close` is False)."""
    rng = random.Random(seed)
    db = lsm.LsmDB(str(path), **SMALL)
    for i in range(n):
        key = f"k{rng.randrange(600):05d}".encode()
        if rng.random() < 0.15:
            db.rm(key)
        elif rng.random() < 0.2:
            b = kv.WriteBatch()
            for j in range(rng.randrange(1, 5)):
                b.set(key + bytes([j]), rng.randbytes(rng.randrange(90)))
            b.rm(f"k{rng.randrange(600):05d}".encode())
            db.submit(b)
        else:
            db.set(key, rng.randbytes(rng.randrange(1, 120)))
        if i == n // 2:
            db.compact()
    got = list(db.iterate())
    if close:
        db.close()
    return got


def files_of(path: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())
            if p.is_file()}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lsm_directory_opens_in_the_other_package(tmp_path, writer):
    """A DB directory one package wrote (SSTs on several levels, a WAL
    tail left by a crash) opens in the other with the same iterate()
    and point reads, and keeps taking writes there."""
    w_lsm, w_kv = (jlsm, jkv) if writer == "jax" else (tlsm, tkv)
    r_lsm = tlsm if writer == "jax" else jlsm
    path = tmp_path / "db"
    want = drive(w_lsm, w_kv, path, seed=3, close=False)   # crash
    db = r_lsm.LsmDB(str(path), **SMALL)
    assert list(db.iterate()) == want
    for k, v in want[::37]:
        assert db.get(k) == v
    db.set(b"zz-after", b"1")
    db.close()
    back = w_lsm.LsmDB(str(path), **SMALL)
    assert list(back.iterate()) == want + [(b"zz-after", b"1")]
    back.close()


def test_lsm_files_equal_byte_for_byte(tmp_path):
    """The same batch sequence writes the same files: manifest, every
    SST and the WAL left open at a crash."""
    want_j = drive(jlsm, jkv, tmp_path / "j", seed=9, close=False)
    want_t = drive(tlsm, tkv, tmp_path / "t", seed=9, close=False)
    assert want_j == want_t
    fj, ft = files_of(tmp_path / "j"), files_of(tmp_path / "t")
    assert sorted(fj) == sorted(ft)
    assert any(name.endswith(".sst") for name in fj)
    assert fj["wal.lsm"]
    for name in fj:
        assert fj[name] == ft[name], name


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_logdb_directory_migrates_in_the_other_package(tmp_path, writer):
    """A LogDB data dir written by one package migrates to LSM on the
    other package's first open_kv, with every key intact."""
    w_kv, r_kv = (jkv, tkv) if writer == "jax" else (tkv, jkv)
    path = str(tmp_path / "db")
    old = w_kv.LogDB(path, compact_every=8)
    rng = random.Random(5)
    want = {}
    for i in range(60):
        k = f"m{rng.randrange(40):03d}".encode()
        v = os.urandom(rng.randrange(1, 50))
        old.set(k, v)
        want[k] = v
    old.close()
    db = r_kv.open_kv(path)
    assert type(db).__name__ == "LsmDB"
    assert dict(db.iterate()) == want
    db.close()
    assert not (tmp_path / "db" / "snapshot.json").exists()

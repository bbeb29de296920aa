"""Deep scrub in the port (ceph_tpu_torch/osd/scrub.py) against the JAX
package's: the five backend-level scrub scenarios of
tests/test_scrub_recovery.py, replayed on both sides with the same
seeded payloads and the same injected faults.  Each side's errors (in
order), repaired list, device/host byte split, scrub perf counters and
the shard bytes after repair must be equal, and the reference test's
own assertions must hold on the port.  Pools: jerasure k=4 m=2 (the
reference test's) and the port's torch plugin on the CPU (jax on the
JAX side), whose repair decodes through K1's plain version.

The port's backends run on the CPU (`device="cpu"`): scrub then takes
the host crc32c by default, and `use_device=True` runs K5's plain
version, as the reference test forces its jnp formulation on the CPU."""

import numpy as np
import pytest

import ceph_tpu.ec as jec
import ceph_tpu.osd.ec_backend as jbe
import ceph_tpu.osd.ec_transaction as ject
import ceph_tpu.osd.ec_util as jutil
import ceph_tpu.osd.scrub as jscrub
import ceph_tpu.osd.types as jtypes
import ceph_tpu.store as jstore
import ceph_tpu.store.object_store as jos
import ceph_tpu_torch.ec as tec
import ceph_tpu_torch.osd.ec_backend as tbe
import ceph_tpu_torch.osd.ec_transaction as tect
import ceph_tpu_torch.osd.ec_util as tutil
import ceph_tpu_torch.osd.scrub as tscrub
import ceph_tpu_torch.osd.types as ttypes
import ceph_tpu_torch.store as tstore
import ceph_tpu_torch.store.object_store as tos

SCRUB_COUNTERS = ("ec_scrub_device_bytes", "ec_scrub_host_bytes")
PLUGINS = ("jerasure", "torch")


class Side:
    def __init__(self, port: bool, plugin: str):
        self.port = port
        (self.ec, self.be, self.ect, self.util, self.scrub, self.types,
         self.store_mod, self.os) = \
            (tec, tbe, tect, tutil, tscrub, ttypes, tstore, tos) if port \
            else (jec, jbe, ject, jutil, jscrub, jtypes, jstore, jos)
        prof = {"k": "4", "m": "2"}
        if plugin == "torch":
            if port:
                prof["device"] = "cpu"
            else:
                plugin = "jax"
        self.codec = self.ec.ErasureCodePluginRegistry.instance().factory(
            plugin, prof)
        self.store = self.store_mod.MemStore()
        self.store.mount()
        self.shards = self.be.LocalShardBackend(
            self.store, self.types.pg_t(1, 0), 6)
        kw = {"device": "cpu"} if port else {}
        self.backend = self.be.ECBackend(
            self.codec, self.util.StripeInfo(4 * 64, 64), self.shards, **kw)

    def oid(self, name):
        return self.types.hobject_t(pool=1, name=name)

    def put(self, name, payload, version=1):
        txn = self.ect.PGTransaction()
        txn.write(self.oid(name), 0, payload)
        done = []
        self.backend.submit_transaction(
            txn, self.types.eversion_t(1, version), lambda: done.append(1))
        assert done

    def write_shard(self, name, shard, off, data):
        t = self.os.Transaction()
        t.write(self.ect.shard_oid(self.oid(name), shard), off,
                np.frombuffer(data, dtype=np.uint8))
        self.store.queue_transactions(self.shards.cids[shard], [t])

    def remove_shard(self, name, shard):
        t = self.os.Transaction()
        t.remove(self.ect.shard_oid(self.oid(name), shard))
        self.store.queue_transactions(self.shards.cids[shard], [t])

    def read_shard(self, name, shard):
        return self.store.read(self.shards.cids[shard],
                               self.ect.shard_oid(self.oid(name), shard))

    def scrub_pg(self, names, **kw):
        return self.scrub.scrub_pg(self.backend,
                                   [self.oid(n) for n in names], **kw)

    def counters(self):
        dump = self.backend.perf.dump()
        return {k: dump[k] for k in SCRUB_COUNTERS}


def _errs(errors):
    return [(e.oid.name, e.shard, e.kind, e.detail) for e in errors]


def _result(res):
    return {"objects": res.objects, "errors": _errs(res.errors),
            "repaired": _errs(res.repaired), "clean": res.clean,
            "device_bytes": res.device_bytes, "host_bytes": res.host_bytes}


def _shards(side, names):
    return {(n, s): (None if (d := side.read_shard(n, s)) is None
                     else bytes(d))
            for n in names for s in range(6)}


def clean_pg(side):
    rng = np.random.default_rng(0)
    names = [f"o{i}" for i in range(3)]
    for i, n in enumerate(names):
        side.put(n, rng.integers(0, 256, 512, dtype=np.uint8), version=i + 1)
    res = side.scrub_pg(names, deep=True)
    assert res.clean and res.objects == 3
    return {"res": _result(res), "perf": side.counters()}


def bitrot_and_repair(side):
    rng = np.random.default_rng(1)
    side.put("victim", rng.integers(0, 256, 1024, dtype=np.uint8))
    original = side.read_shard("victim", 3).copy()
    side.write_shard("victim", 3, 10, b"\xde\xad\xbe\xef")
    res = side.scrub_pg(["victim"], deep=True)
    assert not res.clean
    assert any(e.kind == "crc_mismatch" and e.shard == 3
               for e in res.errors)
    res_shallow = side.scrub_pg(["victim"], deep=False)
    assert res_shallow.clean
    res2 = side.scrub_pg(["victim"], deep=True, repair=True)
    assert res2.clean and res2.repaired
    np.testing.assert_array_equal(side.read_shard("victim", 3), original)
    return {"res": [_result(r) for r in (res, res_shallow, res2)],
            "perf": side.counters(), "shards": _shards(side, ["victim"])}


def missing_shard(side):
    side.put("x", np.ones(512, dtype=np.uint8))
    side.remove_shard("x", 1)
    res = side.scrub_pg(["x"], deep=False)
    assert any(e.kind == "missing" and e.shard == 1 for e in res.errors)
    res2 = side.scrub_pg(["x"], deep=True, repair=True)
    assert res2.clean
    return {"res": [_result(r) for r in (res, res2)],
            "perf": side.counters(), "shards": _shards(side, ["x"])}


def device_path_matches_host(side):
    rng = np.random.default_rng(7)
    names = [f"d{i}" for i in range(3)]
    for i, n in enumerate(names):
        side.put(n, rng.integers(0, 256, 9000 + 4096 * i, dtype=np.uint8),
                 version=i + 1)
    res = side.scrub_pg(names, deep=True, use_device=True)
    assert res.clean and res.objects == 3
    assert res.device_bytes >= 3 * 6 * 2048
    dump = side.backend.perf.dump()
    assert dump["ec_scrub_device_bytes"] == res.device_bytes
    assert dump["ec_scrub_host_bytes"] == res.host_bytes
    side.write_shard("d1", 2, 5, b"\x01\x02\x03")
    res_dev = side.scrub_pg(names, deep=True, use_device=True)
    res_host = side.scrub_pg(names, deep=True, use_device=False)
    assert res_host.host_bytes > 0 and res_host.device_bytes == 0
    for r in (res_dev, res_host):
        assert [(e.oid.name, e.shard, e.kind) for e in r.errors] == \
            [("d1", 2, "crc_mismatch")]
    return {"res": [_result(r) for r in (res, res_dev, res_host)],
            "perf": side.counters()}


def chunked_batches_reads(side):
    rng = np.random.default_rng(8)
    names = [f"c{i}" for i in range(4)]
    for i, n in enumerate(names):
        side.put(n, rng.integers(0, 256, 1024, dtype=np.uint8),
                 version=i + 1)
    side.remove_shard("c2", 0)
    res = side.scrub_pg(names, deep=True, repair=True, chunk_bytes=512)
    assert res.objects == 4
    assert res.clean and res.repaired
    return {"res": _result(res), "perf": side.counters(),
            "shards": _shards(side, names)}


SCENARIOS = {f.__name__: f for f in (clean_pg, bitrot_and_repair,
                                     missing_shard, device_path_matches_host,
                                     chunked_batches_reads)}


@pytest.mark.parametrize("plugin", PLUGINS)
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scrub_scenario_matches_reference(scenario, plugin):
    ref = SCENARIOS[scenario](Side(False, plugin))
    port = SCENARIOS[scenario](Side(True, plugin))
    assert port == ref


@pytest.mark.parametrize("plugin", PLUGINS)
def test_scrub_object_matches_reference(plugin):
    """scrub_object (the repair re-check) on a clean, a rotted and a
    shard-less object, host and device crc."""
    out = []
    for side in (Side(False, plugin), Side(True, plugin)):
        rng = np.random.default_rng(11)
        for i, n in enumerate(("a", "b", "c")):
            side.put(n, rng.integers(0, 256, 20000, dtype=np.uint8),
                     version=i + 1)
        side.write_shard("b", 4, 2049, b"\xff")
        side.remove_shard("c", 5)
        got = []
        for n in ("a", "b", "c", "absent"):
            for dev in (False, True):
                got.append(_errs(side.scrub.scrub_object(
                    side.backend, side.oid(n), deep=True, use_device=dev)))
        out.append((got, side.counters()))
    assert out[1] == out[0]
    assert out[1][0][2] == out[1][0][3] != []


def test_port_default_is_host_crc_on_the_cpu():
    side = Side(True, "jerasure")
    side.put("h", np.arange(9000, dtype=np.uint8))
    res = side.scrub_pg(["h"], deep=True)
    assert res.clean and res.device_bytes == 0 and res.host_bytes > 0
    assert not tscrub._use_device_default(side.backend)


def test_repair_decodes_through_the_codec(monkeypatch):
    """_repair_shards rebuilds through backend.ec_impl.decode_chunks
    (K1 on the card) and writes the reference's recovery attrs."""
    side = Side(True, "torch")
    rng = np.random.default_rng(5)
    side.put("r", rng.integers(0, 256, 8192, dtype=np.uint8))
    want = {s: side.read_shard("r", s).copy() for s in (0, 4)}
    calls = []
    orig = side.codec.decode_chunks

    def spy(dense, erasures):
        calls.append(sorted(erasures))
        return orig(dense, erasures)
    monkeypatch.setattr(side.codec, "decode_chunks", spy)
    side.write_shard("r", 0, 0, b"\x00\x01")
    side.write_shard("r", 4, 100, b"\x07")
    res = side.scrub_pg(["r"], deep=True, repair=True)
    assert res.clean and len(res.repaired) == 2
    assert calls == [[0, 4]]
    for s, d in want.items():
        np.testing.assert_array_equal(side.read_shard("r", s), d)

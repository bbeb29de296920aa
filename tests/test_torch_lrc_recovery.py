"""ECBackend recovery of an LRC pool on the layered plugin's device path
(ceph_tpu_torch/osd/ec_backend.py, `device="cpu"`: the plain versions).

The documented k=4 m=2 l=3 profile in its layered form: objects are
written through the device codec and through the host layered codec
alike, one OSD's shard is lost, and recovery reads only the 3 other
chunks of the lost chunk's local group (ec_repair_helper_bytes,
ec_local_repairs, the bytes the shards served), rebuilding shards and
pushing HashInfo crcs equal to the host pool's, directly and through
the per-host launch queue.  A failed helper read falls back to the
full-read decode (ec_local_repair_fallbacks).  A Reed-Solomon pool and
the host LRC pool read every source shard, as before."""

import json

import numpy as np
import pytest

from ceph_tpu_torch.ec import ErasureCodePluginRegistry
from ceph_tpu_torch.ec.plugins import ec_lrc
from ceph_tpu_torch.osd import ec_backend, ec_transaction, ec_util, types
from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
from ceph_tpu_torch.store import MemStore
from ceph_tpu_torch.store.object_store import Transaction

LAYERED = {"mapping": "__DD__DD",
           "layers": json.dumps([["_cDD_cDD", ""], ["cDDD____", ""],
                                 ["____cDDD", ""]])}
CHUNK = 1024
N_OBJECTS = 5


class CountingShards(ec_backend.LocalShardBackend):
    """`down` shards fail reads; the bytes each shard served are
    counted."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.down: set[int] = set()
        self.read_bytes: dict[int, int] = {}

    def sub_read(self, shard, oid, off, length, on_done):
        if shard in self.down:
            on_done(shard, None)
            return
        self.read_bytes[shard] = self.read_bytes.get(shard, 0) + length
        super().sub_read(shard, oid, off, length, on_done)


class Pool:
    def __init__(self, plugin, profile, queue=None):
        self.codec = ErasureCodePluginRegistry.instance().factory(
            plugin, dict(profile))
        k, n = self.codec.get_data_chunk_count(), self.codec.get_chunk_count()
        self.n = n
        self.store = MemStore()
        self.store.mount()
        self.shards = CountingShards(self.store, types.pg_t(1, 0), n)
        self.be = ec_backend.ECBackend(
            self.codec, ec_util.StripeInfo(k * CHUNK, CHUNK), self.shards,
            launch_queue=queue, device="cpu")

    def write(self, payloads):
        oids = []
        for i, p in enumerate(payloads):
            acked = []
            oid = types.hobject_t(pool=1, name=f"o{i}")
            txn = ec_transaction.PGTransaction()
            txn.write(oid, 0, p)
            self.be.submit_transaction(txn, types.eversion_t(1, i + 1),
                                       lambda: acked.append(1))
            assert acked
            oids.append(oid)
        return oids

    def shard(self, oid, s):
        return self.store.read(self.shards.cids[s],
                               ec_transaction.shard_oid(oid, s)).copy()

    def lose(self, oids, s):
        for oid in oids:
            t = Transaction()
            t.remove(ec_transaction.shard_oid(oid, s))
            self.store.queue_transactions(self.shards.cids[s], [t])

    def recover(self, oids, missing):
        pushed = {}
        self.shards.read_bytes.clear()
        res = self.be.recover_shards_batch(
            [(o, list(missing)) for o in oids],
            lambda o: (lambda s, data, h, o=o: pushed.__setitem__(
                (o.name, s), (np.asarray(data).copy(), h.encode()))))
        assert all(e is None for e in res.values()), res
        return pushed

    def counters(self):
        return self.be.repair_status()


def _payloads(seed):
    rng = np.random.default_rng(seed)
    # two stripes an object, the last one short
    return [rng.integers(0, 256, 4 * CHUNK * 2 - 100 * i, dtype=np.uint8)
            for i in range(N_OBJECTS)]


@pytest.fixture()
def queue():
    q = ECLaunchQueue(window_us=500.0, device="cpu")
    yield q
    q.close()


@pytest.mark.parametrize("lost", range(8))
@pytest.mark.parametrize("queued", [False, True], ids=["direct", "queue"])
def test_local_recovery(lost, queued, queue):
    """One OSD lost: each object rebuilt from its local group's 3 shards,
    equal to what the host pool stored, with the host pool's hinfo."""
    payloads = _payloads(lost)
    host = Pool("lrc", LAYERED)
    dev = Pool("lrc", dict(LAYERED, device="cpu"),
               queue=queue if queued else None)
    oids = host.write(payloads)
    assert dev.write(payloads) == oids
    assert dev.be.fused_path is not None      # the fused write path ran
    for oid in oids:
        for s in range(8):
            np.testing.assert_array_equal(dev.shard(oid, s),
                                          host.shard(oid, s))
        assert dev.be._get_hinfo(oid).encode() == \
            host.be._get_hinfo(oid).encode()
    want = {oid.name: dev.shard(oid, lost) for oid in oids}
    dev.lose(oids, lost)
    pushed = dev.recover(oids, [lost])
    helpers = sorted(dev.codec.minimum_to_decode(
        [lost], [c for c in range(8) if c != lost]))
    assert len(helpers) == 3
    assert sorted(dev.shards.read_bytes) == helpers
    chunk_len = 2 * CHUNK
    assert all(b == N_OBJECTS * chunk_len
               for b in dev.shards.read_bytes.values())
    for oid in oids:
        data, hinfo = pushed[(oid.name, lost)]
        np.testing.assert_array_equal(data, want[oid.name])
        assert hinfo == host.be._get_hinfo(oid).encode()
    st = dev.counters()
    assert st["helper_bytes_read"] == 3 * chunk_len * N_OBJECTS
    assert st["reconstructed_bytes"] == chunk_len * N_OBJECTS
    assert st["local_repairs"] == N_OBJECTS
    assert st["local_repair_fallbacks"] == 0
    if queued:
        assert queue.status()["decode_launches"] >= 1


def test_failed_helper_falls_back_to_full_reads():
    payloads = _payloads(20)
    dev = Pool("lrc", dict(LAYERED, device="cpu"))
    oids = dev.write(payloads)
    want = {oid.name: dev.shard(oid, 0) for oid in oids}
    dev.lose(oids, 0)
    dev.shards.down = {1}                  # a helper of chunk 0's group
    pushed = dev.recover(oids, [0])
    for oid in oids:
        np.testing.assert_array_equal(pushed[(oid.name, 0)][0],
                                      want[oid.name])
    st = dev.counters()
    assert st["local_repair_fallbacks"] == N_OBJECTS
    assert st["local_repairs"] == 0
    assert sorted(dev.shards.read_bytes) == [2, 3, 4, 5, 6, 7]


@pytest.mark.parametrize("objects_a_launch", [1, N_OBJECTS])
def test_local_recovery_keeps_the_launch_width_cap(objects_a_launch):
    """A local repair group decodes in launches of at most
    DECODE_MAX_LAUNCH_W columns, as every recovery group does: one plan
    apply (one rebuilt row) a launch."""
    payloads = _payloads(50)
    dev = Pool("lrc", dict(LAYERED, device="cpu"))
    oids = dev.write(payloads)
    want = {oid.name: dev.shard(oid, 0) for oid in oids}
    dev.lose(oids, 0)
    dev.be.DECODE_MAX_LAUNCH_W = objects_a_launch * 2 * CHUNK
    ec_lrc.reset_local_repair_counts()
    pushed = dev.recover(oids, [0])
    for oid in oids:
        np.testing.assert_array_equal(pushed[(oid.name, 0)][0],
                                      want[oid.name])
    counts = ec_lrc.local_repair_counts()
    assert counts["rebuilt_rows"] == -(-N_OBJECTS // objects_a_launch)
    assert counts["helper_rows"] == 3 * counts["rebuilt_rows"]
    assert dev.counters()["local_repairs"] == N_OBJECTS


def test_two_lost_chunks_decode_through_the_device_path():
    """Two OSDs of both local groups lost: the minimum set is k or more,
    so every source shard is read and the device decode rebuilds both."""
    payloads = _payloads(30)
    dev = Pool("lrc", dict(LAYERED, device="cpu"))
    oids = dev.write(payloads)
    want = {(oid.name, s): dev.shard(oid, s) for oid in oids for s in (0, 2)}
    for s in (0, 2):
        dev.lose(oids, s)
    pushed = dev.recover(oids, [0, 2])
    for key, data in want.items():
        np.testing.assert_array_equal(pushed[key][0], data)
    assert sorted(dev.shards.read_bytes) == [1, 3, 4, 5, 6, 7]
    assert dev.counters()["local_repairs"] == 0


@pytest.mark.parametrize("plugin,profile", [
    ("torch", {"k": "4", "m": "2", "device": "cpu"}),
    ("jerasure", {"k": "4", "m": "2"}),
    ("lrc", LAYERED)], ids=["torch", "jerasure", "lrc_host"])
def test_other_pools_read_every_source(plugin, profile):
    """Reed-Solomon pools and the host LRC pool read every source shard
    of every object, as before."""
    payloads = _payloads(40)
    pool = Pool(plugin, profile)
    oids = pool.write(payloads)
    want = {oid.name: pool.shard(oid, 0) for oid in oids}
    pool.lose(oids, 0)
    pushed = pool.recover(oids, [0])
    for oid in oids:
        np.testing.assert_array_equal(pushed[(oid.name, 0)][0],
                                      want[oid.name])
    assert sorted(pool.shards.read_bytes) == list(range(1, pool.n))
    st = pool.counters()
    assert st["helper_bytes_read"] == (pool.n - 1) * 2 * CHUNK * N_OBJECTS
    assert st["local_repairs"] == 0

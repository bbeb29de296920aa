"""The port's boot prewarm (ceph_tpu_torch/ops/prewarm.py) and kernel
library cache (ops/compile_cache.py) on the CPU: the plan's entries are
the JAX package's, its predicted buckets are exactly the buckets run()
seeds, a depth-2 pipelined write storm afterwards lands only on seeded
buckets (every first launch a cache hit, no build, no stall), a zero
budget truncates the plan without failing, and the cache's
enable/status/reset contract on a test directory."""

import numpy as np
import pytest

import ceph_tpu.ec as jec
import ceph_tpu.ops.prewarm as jprewarm
from ceph_tpu_torch.ec import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import _build, compile_cache, prewarm
from ceph_tpu_torch.ops.profiler import DeviceProfiler, device_profiler
from ceph_tpu_torch.osd.ec_backend import ECBackend, LocalShardBackend
from ceph_tpu_torch.osd.ec_transaction import PGTransaction
from ceph_tpu_torch.osd.ec_util import StripeInfo
from ceph_tpu_torch.osd.types import eversion_t, hobject_t, pg_t
from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
from ceph_tpu_torch.store import MemStore


# a budget no plan here reaches, even on a loaded machine: the tests that
# need every entry run must not be cut by the clock
BUDGET_S = 600.0


def make_codec(k=2, m=1):
    return ErasureCodePluginRegistry.instance().factory(
        "torch", {"k": str(k), "m": str(m), "device": "cpu"})


@pytest.fixture(autouse=True)
def _reset_all():
    def reset():
        DeviceProfiler.reset_host()
        ECLaunchQueue.reset_host()
        prewarm.reset_for_tests()
        compile_cache.reset_for_tests()
    reset()
    yield
    reset()


def _storm(codec, n=4):
    """Depth-2 pipelined write storm through a launch queue."""
    q = ECLaunchQueue(window_us=60_000_000.0, device="cpu")
    store = MemStore()
    store.mount()
    shards = LocalShardBackend(store, pg_t(1, 0), codec.get_chunk_count())
    be = ECBackend(codec, StripeInfo(codec.get_data_chunk_count() * 64, 64),
                   shards, launch_queue=q, perf_name="ec.1.0")
    rng = np.random.default_rng(16)
    done = []
    try:
        with be.pipeline():
            for i in range(n):
                txn = PGTransaction()
                txn.write(hobject_t(pool=1, name=f"pw{i}"), 0,
                          rng.integers(0, 256, 512, dtype=np.uint8))
                be.submit_transaction(txn, eversion_t(1, i + 1),
                                      lambda: done.append(1))
    finally:
        q.close()
    assert len(done) == n


@pytest.mark.parametrize("kwargs", [
    {}, {"widths": [1 << 20, 4 << 20], "run_counts": [1, 2, 4],
         "plain_widths": [4096], "decode_widths": [524288]}],
    ids=["defaults", "storm_widths"])
def test_plan_entries_match_jax_and_prediction_matches_run(kwargs):
    """The entries (kinds, widths, run counts, erasure patterns, order)
    are the reference plan's; planned_buckets() equals the buckets run()
    seeds; every entry ran on an already built (here: no) library."""
    codec = make_codec(8, 3)
    ref = jprewarm.PrewarmPlan(
        jec.ErasureCodePluginRegistry.instance().factory(
            "jax", {"k": "8", "m": "3"}), **kwargs)
    plan = prewarm.PrewarmPlan(codec, profiler=device_profiler(),
                               budget_s=BUDGET_S, **kwargs)
    assert plan.entries == ref.entries
    assert plan.status["planned"] == ref.status["planned"]
    predicted = plan.planned_buckets()
    st = plan.run()
    assert st["done"] == st["planned"] and st["skipped"] == 0
    assert not st["truncated"] and st["compiles"] == 0
    assert st["buckets"] == predicted
    assert device_profiler().prewarm_summary()["buckets"] == len(
        set(predicted))


def test_plan_covers_depth2_write_storm_exactly():
    """A depth-2 pipelined write storm after prewarm lands only on
    prewarmed buckets: each record's first launch a cache hit, no
    `compiled` record, no stall.  The port's labels are exact widths and
    run counts (the reference's were powers of two), so the plan names
    the storm's: its queue launches three 512 B runs (one 2 KiB tile
    each) and then one."""
    codec = make_codec()
    host = device_profiler()
    plan = prewarm.PrewarmPlan(codec, profiler=host, budget_s=BUDGET_S,
                               widths=[2048, 6144], run_counts=[1, 3])
    predicted = set(plan.planned_buckets())
    st = plan.run()
    seeded = set(st["buckets"])
    assert seeded == predicted
    _storm(codec)
    recent = host.profile()["recent"]
    launched = {r["bucket"] for r in recent}
    assert launched == {"x:w32_flat:w6144:r3", "x:w32_flat:w2048:r1"}
    assert launched <= seeded, f"cold buckets: {launched - seeded}"
    assert host.compile_stalls == 0
    for r in recent:
        assert r["cache_hit"] and not r["compiled"], r
    ledger = host.compile_ledger()
    assert ledger["prewarm"]["buckets"] == len(seeded)
    assert ledger["window"]["events"] == 0
    assert host.perf.dump()["ec_prewarm_cache_hits"] == len(st["buckets"])


def test_default_plan_leaves_no_storm_launch_compiled():
    """With the reference's default plan the storm's three-run launch is
    a label the plan does not seed, yet nothing compiles per shape on
    the card: its first launch is a cache hit all the same."""
    codec = make_codec()
    host = device_profiler()
    st = prewarm.PrewarmPlan(codec, profiler=host, budget_s=BUDGET_S).run()
    _storm(codec)
    recent = host.profile()["recent"]
    assert {r["bucket"] for r in recent} - set(st["buckets"]) == \
        {"x:w32_flat:w6144:r3"}
    assert all(r["cache_hit"] and not r["compiled"] for r in recent)
    assert host.compile_stalls == 0


def test_budget_cutoff_and_run_once():
    """budget_s=0 truncates the plan before the first entry, counting
    every entry skipped; run_once runs one plan a process and hands
    later callers its status."""
    plan = prewarm.PrewarmPlan(make_codec(), budget_s=0.0)
    st = plan.run()
    assert st["truncated"]
    assert st["done"] == 0 and st["skipped"] == st["planned"]
    assert prewarm.last_status() is None
    first = prewarm.run_once(make_codec(), budget_s=BUDGET_S,
                             widths=[2048], run_counts=[1],
                             plain_widths=[2048], decode_widths=[2048])
    assert first["done"] == first["planned"] == 3   # c, d and x
    again = prewarm.run_once(make_codec())
    assert again["reused"] and again["done"] == 3
    assert prewarm.last_status() is first


def test_failing_entry_is_skipped():
    """An entry that raises is counted skipped and the rest still run:
    nothing runs in its place."""
    codec = make_codec()

    def boom(*a, **kw):
        raise RuntimeError("injected")
    codec.decode_chunks = boom
    st = prewarm.PrewarmPlan(codec, decode_widths=[2048],
                             budget_s=BUDGET_S).run()
    assert st["skipped"] == 1 and st["done"] == st["planned"] - 1
    assert not any(b.startswith("d:") for b in st["buckets"])


def test_compile_cache_enable_status_reset(tmp_path):
    cache = tmp_path / "kernels"
    assert compile_cache.status()["enabled"] is False
    assert compile_cache.enable(str(cache))
    st = compile_cache.status()
    assert st["enabled"] and st["dir"] == str(cache)
    assert st["entries"] == 0 and st["bytes"] == 0     # nothing built
    assert st["hits"] == compile_cache.hit_count() == 0
    assert st["kernel_library"] == _build.status()
    assert _build.library_path().parent == cache
    # idempotent: the first caller's directory wins
    assert compile_cache.enable(str(tmp_path / "other"))
    assert compile_cache.cache_dir() == str(cache)
    (cache / f"libceph_tpu_torch_kernels.{'0' * 16}.so").write_bytes(b"x")
    assert compile_cache.status()["entries"] == 1
    compile_cache.reset_for_tests()
    assert not compile_cache.enabled()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR


def test_compile_cache_unusable_dir_stays_disabled(tmp_path, monkeypatch):
    """A directory that cannot be made leaves the cache disabled with
    its error, and the build directory where it was: no fallback."""
    blocker = tmp_path / "file"
    blocker.write_bytes(b"")
    assert not compile_cache.enable(str(blocker / "sub"))
    st = compile_cache.status()
    assert not st["enabled"] and "mkdir" in st["error"]
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    # the env override names the default directory
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env"))
    assert compile_cache.default_cache_dir() == tmp_path / "env"
    assert compile_cache.enable()
    assert compile_cache.cache_dir() == str(tmp_path / "env")

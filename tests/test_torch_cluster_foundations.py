"""The cluster foundations of the port against the JAX package's: the op
tracker (common/tracked_op.py) with ECBackend's tracked ops, lockdep,
the omap codec and buffers, the compressor, cephx auth, the rados op
and omap surface of a port cluster, and object-class calls (`lock`,
`numops`).

Most cases replay the reference's own tests on the port: `ported(name)`
loads tests/<name>.py with every `ceph_tpu` import pointed at
`ceph_tpu_torch` (plus the substitutions a case names: a cluster on
the CPU, the `torch` plugin) and the case runs unchanged.  The rest
run the same seeded inputs through both packages and compare."""

import errno
import inspect
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest

import ceph_tpu.common.buffer as jbuf
import ceph_tpu.common.omap_codec as joc
import ceph_tpu_torch.common.buffer as tbuf
import ceph_tpu_torch.common.omap_codec as toc
from ceph_tpu_torch.rados.client import RadosError
from ceph_tpu_torch.tools.vstart import Cluster

HERE = Path(__file__).resolve().parent

# every port cluster in a replayed case runs its codecs on the CPU, and
# a profile that names the card's plugin names the port's
CPU_CLUSTER = ((re.compile(r"\bCluster\("), 'Cluster(device="cpu", '),
               (re.compile(r'"plugin": "jax"'), '"plugin": "torch"'))


def ported(name: str, subs=()) -> types.ModuleType:
    """tests/<name>.py with `ceph_tpu` imports pointed at the port, a
    port cluster on the CPU, and each (old, new) text substitution of
    `subs` (each must occur), as a fresh module."""
    path = HERE / f"{name}.py"
    src = re.sub(r"\bceph_tpu\b", "ceph_tpu_torch", path.read_text())
    for pat, new in CPU_CLUSTER:
        src = pat.sub(new, src)
    for old, new in subs:
        assert old in src, f"{name}: {old!r} not found"
        src = src.replace(old, new)
    mod = types.ModuleType(f"{name}_on_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


@pytest.fixture(scope="module", autouse=True)
def port_singletons():
    """A port cluster's daemons build the process's host singletons (the
    launch queue on the cluster's device, the flight recorder, the
    library cache, the prewarm status): drop them when the module ends,
    so a later test builds its own."""
    yield
    from ceph_tpu_torch.ops import compile_cache, prewarm
    from ceph_tpu_torch.ops.profiler import DeviceProfiler
    from ceph_tpu_torch.parallel.launch_queue import ECLaunchQueue
    from ceph_tpu_torch.parallel.service import MeshService
    MeshService.reset()
    ECLaunchQueue.reset_host()
    DeviceProfiler.reset_host()
    prewarm.reset_for_tests()
    compile_cache.reset_for_tests()


def run_case(mod: types.ModuleType, case: str, **fixtures):
    """Call one test function of a ported module with the fixtures its
    signature names."""
    fn = getattr(mod, case)
    want = inspect.signature(fn).parameters
    return fn(**{k: fixtures[k] for k in want})


def cases(mod: types.ModuleType) -> list[str]:
    """The test functions of a ported module, in their file's order."""
    return [n for n, f in vars(mod).items()
            if n.startswith("test_") and inspect.isfunction(f)]


def replay(mod: types.ModuleType, case: str, request):
    """Call one test function of a ported module with the fixtures its
    signature names, taken from pytest (the replaying file imports the
    ported module's own fixtures)."""
    fn = getattr(mod, case)
    return fn(**{k: request.getfixturevalue(k)
                 for k in inspect.signature(fn).parameters})


# -- the op tracker and ECBackend's tracked ops (tests/test_optracker.py) ----

OPTRACKER = ported("test_optracker", subs=[(
    "ECBackend(codec, sinfo, shards, dispatch_depth=2)",
    'ECBackend(codec, sinfo, shards, dispatch_depth=2, device="cpu")')])


@pytest.mark.parametrize("case", [
    "test_trace_context_child_and_wire",
    "test_canonical_stage_strips_shard_suffix",
    "test_historic_ring_eviction_bounds",
    "test_tracing_off_fast_path_zero_events",
    "test_slow_op_latch_and_blame_in_flight",
    "test_slow_op_blames_largest_gap_after_completion",
    "test_stage_latency_histograms",
    "test_sharded_wq_marks_queue_and_dequeue",
    "test_pipeline_stage_timeline_depth2_overlap",
    "test_pipeline_failure_marks_failed_stage",
    "test_mosdop_trace_wire_roundtrip",
    "test_exporter_daemon_up_and_scrape_errors"])
def test_optracker_replay(case, tmp_path):
    run_case(OPTRACKER, case, tmp_path=tmp_path)


def test_trace_context_wire_crosses_packages():
    from ceph_tpu.common.tracked_op import TraceContext as JCtx
    from ceph_tpu_torch.common.tracked_op import TraceContext as TCtx
    t = TCtx.new().child()
    j = JCtx.from_wire(json.loads(json.dumps(t.to_wire())))
    assert (j.trace_id, j.span_id) == (t.trace_id, t.span_id)
    assert TCtx.from_wire(j.to_wire()).to_wire() == t.to_wire()


# -- lockdep (tests/test_lockdep.py; its cluster soak needs rbd) -------------

LOCKDEP = ported("test_lockdep")


@pytest.mark.parametrize("case", ["test_abba_cycle_detected",
                                  "test_consistent_order_passes",
                                  "test_transitive_cycle_detected"])
def test_lockdep_replay(case):
    run_case(LOCKDEP, case)


# -- omap codec and buffers: the same bytes from both packages ---------------

def test_omap_codec_and_buffers_match_reference():
    rng = np.random.default_rng(11)
    kv = {bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                             dtype=np.uint8)):
          bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                             dtype=np.uint8)) for _ in range(50)}
    keys = sorted(kv)[:20]
    for fn in ("encode_kv", "encode_keys"):
        arg = kv if fn == "encode_kv" else keys
        t_out, j_out = getattr(toc, fn)(arg), getattr(joc, fn)(arg)
        assert t_out == j_out
    assert toc.decode_kv(joc.encode_kv(kv))[0] == kv
    assert toc.decode_keys(joc.encode_keys(keys))[0] == keys
    parts = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
             for n in (0, 1, 4095, 4096, 70001)]
    tl, jl = tbuf.BufferList(), jbuf.BufferList()
    for p in parts:
        tl.append(p)
        jl.append(p)
    assert len(tl) == len(jl)
    assert tl.to_bytes() == jl.to_bytes()
    assert tl.crc32c(0) == jl.crc32c(0)
    assert tl.crc32c(0xFFFFFFFF) == jl.crc32c(0xFFFFFFFF)


# -- the compressor (tests/test_compressor.py) -------------------------------

COMPRESSOR = ported("test_compressor")


@pytest.mark.parametrize("case", [
    "test_unknown_and_unavailable", "test_corrupt_stream_fails_loudly",
    "test_wire_compression_negotiated_and_used",
    "test_small_frames_skip_compression",
    "test_no_compression_unless_both_sides_opt_in",
    "test_decompression_bomb_rejected"])
def test_compressor_replay(case):
    run_case(COMPRESSOR, case)


@pytest.mark.parametrize("algo", ["zlib", "bz2", "lzma"])
def test_compressed_bytes_match_reference(algo):
    from ceph_tpu import compressor as jcomp
    from ceph_tpu_torch import compressor as tcomp
    run_case(COMPRESSOR, "test_roundtrip", algo=algo)
    payload = np.random.default_rng(5).integers(
        0, 8, 65536, dtype=np.uint8).tobytes()
    t_out = tcomp.create(algo).compress(payload)
    assert t_out == jcomp.create(algo).compress(payload)
    assert jcomp.create(algo).decompress(t_out) == payload


# -- cephx auth: protocol units (tests/test_auth.py) -------------------------

@pytest.mark.parametrize("case", [
    "test_ticket_roundtrip_and_tamper", "test_ticket_expiry",
    "test_authorizer_verify_and_mutual_proof",
    "test_authorizer_rejects_wrong_key_and_stale_ts",
    "test_forged_authorizer_does_not_burn_nonce",
    "test_service_and_ticket_authorizers",
    "test_secure_frames_reject_replay_and_reorder"])
def test_auth_replay(case):
    # sealing needs the optional `cryptography`; without it the
    # reference raises at use, and so does the port
    pytest.importorskip("cryptography")
    run_case(ported("test_auth"), case)


def test_ticket_sealed_by_port_opens_in_reference():
    pytest.importorskip("cryptography")
    from ceph_tpu.auth import cephx as jcx
    from ceph_tpu_torch.auth import cephx as tcx
    sk = bytes(range(16))
    blob, session_key = tcx.issue_ticket(sk, "client.x", "allow rw")
    t = jcx.decode_ticket(sk, blob)
    assert (t["entity"], t["caps"]) == ("client.x", "allow rw")
    assert t["session_key"] == session_key


# -- the rados op surface on a port cluster (tests/test_rados_ops.py) --------

RADOS_OPS = ported("test_rados_ops")


@pytest.fixture(scope="module")
def rados_cluster():
    with Cluster(n_osds=4, device="cpu") as c:
        cl = c.client()
        cl.create_pool("repl", pg_num=4, size=2)
        cl.set_ec_profile("op21", {"plugin": "jerasure", "k": "2",
                                   "m": "1", "stripe_unit": "1024"})
        cl.create_pool("ecp", "erasure", erasure_code_profile="op21",
                       pg_num=4)
        cl.set_ec_profile("op21t", {"plugin": "torch", "k": "2",
                                    "m": "1", "stripe_unit": "1024"})
        cl.create_pool("ecpt", "erasure", erasure_code_profile="op21t",
                       pg_num=4)
        # tests/test_omap.py's pools
        cl.create_pool("omappool", "replicated", pg_num=4)
        cl.set_ec_profile("om_ec", {"plugin": "jerasure", "k": "2",
                                    "m": "1", "stripe_unit": "1024"})
        cl.create_pool("omapec", "erasure", erasure_code_profile="om_ec",
                       pg_num=4)
        yield c, cl


@pytest.mark.parametrize("pool", ["repl", "ecp", "ecpt"])
@pytest.mark.parametrize("case", [
    "test_create_exclusive", "test_append", "test_zero_inside_and_past_eof",
    "test_xattr_get_rm_cmp", "test_rmxattr_nonexistent_is_enoent",
    "test_compound_vector_sees_staged_state",
    "test_delete_in_compound_sees_absent",
    "test_cmpxattr_guards_compound_op"])
def test_rados_ops_replay(rados_cluster, pool, case):
    _c, cl = rados_cluster
    run_case(RADOS_OPS, case, io=cl.open_ioctx(pool))


OMAP = ported("test_omap")


@pytest.mark.parametrize("case", [
    "test_omap_set_get_roundtrip", "test_omap_get_vals_by_keys_and_rm",
    "test_omap_pagination", "test_omap_header", "test_omap_clear",
    "test_omap_enoent", "test_omap_rejected_on_ec_pool",
    "test_omap_survives_delete_recreate", "test_omap_op_vector_order",
    "test_omap_delete_then_set_one_vector",
    "test_malformed_omap_payload_einval"])
def test_omap_replay(rados_cluster, case):
    run_case(OMAP, case, cluster=rados_cluster)


# -- object classes through the daemon ---------------------------------------

@pytest.mark.parametrize("pool", ["repl", "ecpt"])
def test_cls_numops_and_lock(rados_cluster, pool):
    _c, cl = rados_cluster
    io = cl.open_ioctx(pool)
    io.write_full("num", b"10")
    out = io.execute("num", "numops", "add",
                     json.dumps({"value": 5}).encode())
    assert out == b"15"
    assert io.execute("num", "numops", "mul",
                      json.dumps({"value": 3}).encode()) == b"45"
    assert io.read("num") == b"45"
    req = {"name": "l1", "type": "exclusive", "cookie": "c1",
           "owner": "client.a", "duration": 0}
    io.write_full("lk", b"x")
    io.execute("lk", "lock", "lock", json.dumps(req).encode())
    with pytest.raises(RadosError) as ei:
        io.execute("lk", "lock", "lock",
                   json.dumps(dict(req, cookie="c2",
                                   owner="client.b")).encode())
    assert abs(ei.value.errno) == errno.EBUSY
    info = json.loads(io.execute("lk", "lock", "get_info",
                                 json.dumps({"name": "l1"}).encode()))
    assert list(info["lockers"]) == ["client.a"]
    io.execute("lk", "lock", "unlock",
               json.dumps({"name": "l1", "cookie": "c1",
                           "owner": "client.a"}).encode())

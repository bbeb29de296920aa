"""The port's CephContext foundations (ceph_tpu_torch/common/options.py,
dout.py, admin_socket.py, context.py) against the JAX package's: the
scenarios of tests/test_foundations.py:15-115 replayed on both
packages, and the option schema held key by key."""

import io

import pytest

import ceph_tpu.common.admin_socket as jasok
import ceph_tpu.common.context as jctx
import ceph_tpu.common.dout as jdout
import ceph_tpu.common.options as jopt
import ceph_tpu.common.perf_counters as jperf
import ceph_tpu_torch.common.admin_socket as tasok
import ceph_tpu_torch.common.context as tctx
import ceph_tpu_torch.common.dout as tdout
import ceph_tpu_torch.common.options as topt
import ceph_tpu_torch.common.perf_counters as tperf

SIDES = {"port": (topt, tdout, tasok, tctx, tperf),
         "jax": (jopt, jdout, jasok, jctx, jperf)}
side_ids = pytest.mark.parametrize("side", sorted(SIDES))


def test_schema_matches_reference():
    """Every option of the reference, with its type, bounds, flags and
    default; only the two defaults naming the card's plugin differ."""
    assert sorted(topt.SCHEMA) == sorted(jopt.SCHEMA)
    renamed = {"osd_erasure_code_plugins": "jerasure isa torch",
               "osd_pool_default_erasure_code_profile":
                   "plugin=torch technique=cauchy k=8 m=3"}
    for name, ref in jopt.SCHEMA.items():
        opt = topt.SCHEMA[name]
        assert (opt.type, opt.min, opt.max, opt.enum_values, opt.flags,
                opt.level) == (ref.type, ref.min, ref.max, ref.enum_values,
                               ref.flags, ref.level), name
        assert opt.default == renamed.get(name, ref.default), name
    for name in ("osd_ec_compile_cache", "osd_ec_compile_cache_dir",
                 "osd_ec_prewarm", "osd_ec_prewarm_budget_s",
                 "osd_ec_use_mesh", "mesh_devices"):
        assert name in topt.SCHEMA


@side_ids
def test_config_defaults_and_layers(side):
    c = SIDES[side][0].Config()
    assert c.get("osd_heartbeat_interval") == 1.0
    c.set("osd_heartbeat_interval", "2.5", layer="file")
    assert c.get("osd_heartbeat_interval") == 2.5
    c.set("osd_heartbeat_interval", 5, layer="override")
    assert c.get("osd_heartbeat_interval") == 5.0
    # lower layer can't shadow higher
    c.set("osd_heartbeat_interval", 9, layer="file")
    assert c.get("osd_heartbeat_interval") == 5.0


@side_ids
def test_config_validation(side):
    c = SIDES[side][0].Config()
    with pytest.raises(ValueError):
        c.set("osd_heartbeat_interval", 0.001)  # below min
    with pytest.raises(ValueError):
        c.set("osd_op_queue", "bogus")          # not in enum
    with pytest.raises(KeyError):
        c.set("no_such_option", 1)


@side_ids
def test_config_observer_and_mon_layer(side):
    c = SIDES[side][0].Config()
    seen = []
    c.add_observer("osd_max_backfills", lambda k, v: seen.append((k, v)))
    c.set("osd_max_backfills", 4)
    assert seen == [("osd_max_backfills", 4)]
    c.apply_mon_layer({"osd_max_backfills": 2, "no_such": 1})
    assert c.get("osd_max_backfills") == 4      # override layer wins
    assert seen == [("osd_max_backfills", 4)]


@side_ids
def test_inject_args(side):
    c = SIDES[side][0].Config()
    c.inject_args("--osd-max-backfills 3 --osd-scrub-auto")
    assert c.get("osd_max_backfills") == 3
    assert c.get("osd_scrub_auto") is True


@side_ids
def test_dout_gating_and_ring(side):
    sink = io.StringIO()
    d = SIDES[side][1].DoutStream(sink=sink)
    d.set_level("osd", log=1, gather=5)
    d.log("osd", 1, "visible")
    d.log("osd", 5, "gathered only")
    d.log("osd", 9, "dropped")
    assert "visible" in sink.getvalue()
    assert "gathered only" not in sink.getvalue()
    out = io.StringIO()
    d.dump_recent(out)
    dumped = out.getvalue()
    assert "gathered only" in dumped       # ring kept it
    assert "dropped" not in dumped
    assert [e["msg"] for e in d.recent()] == ["visible", "gathered only"]
    assert [e["msg"] for e in d.recent(1)] == ["gathered only"]


@side_ids
def test_perf_counters(side):
    pc = (SIDES[side][4].PerfCountersBuilder("osd.0")
          .add_u64_counter("op")
          .add_gauge("queue_len")
          .add_time_avg("op_latency")
          .create_perf_counters())
    pc.inc("op")
    pc.inc("op", 4)
    pc.set("queue_len", 7)
    with pc.time("op_latency"):
        pass
    d = pc.dump()
    assert d["op"] == 5
    assert d["queue_len"] == 7
    assert d["op_latency"]["avgcount"] == 1


@side_ids
def test_admin_socket_roundtrip(side, tmp_path):
    asok_mod = SIDES[side][2]
    path = str(tmp_path / "test.asok")
    asok = asok_mod.AdminSocket(path)
    try:
        asok.register_command("hello", lambda cmd: {"hi": cmd.get("who")})
        out = asok_mod.admin_command(path, {"prefix": "hello",
                                            "who": "world"})
        assert out == {"hi": "world"}
        out = asok_mod.admin_command(path, {"prefix": "nope"})
        assert "unknown command" in out["error"]
    finally:
        asok.shutdown()


@side_ids
def test_ceph_context_asok(side, tmp_path):
    asok_mod, ctx = SIDES[side][2], SIDES[side][3]
    path = str(tmp_path / "ctx.asok")
    cct = ctx.CephContext("osd.0", asok_path=path)
    try:
        plugins = cct.preload_erasure_code()
        # the port preloads its card plugin too: it touches no device
        assert plugins == (["jerasure", "isa", "torch"] if side == "port"
                           else ["jerasure", "isa"])
        out = asok_mod.admin_command(path, {"prefix": "config show"})
        assert "osd_heartbeat_interval" in out
        out = asok_mod.admin_command(path, {"prefix": "config set",
                                            "key": "osd_max_backfills",
                                            "value": 2})
        assert out["success"] and out["osd_max_backfills"] == 2
        out = asok_mod.admin_command(path, {"prefix": "perf dump"})
        assert isinstance(out, dict)
        cct.dout("osd", 1, "hello ring")
        out = asok_mod.admin_command(path, {"prefix": "log dump",
                                            "count": 1})
        assert out["entries"][-1]["msg"] == "hello ring"
    finally:
        cct.shutdown()

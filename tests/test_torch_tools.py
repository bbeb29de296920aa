"""The cluster tools on the port, on the CPU: `ceph_cli`,
`metrics_exporter` and `latency` held against the JAX package's, and
the reference's cases that need them replayed on the port (the pg
ledger's asok and exporter surfaces, the progress module through
`ceph_cli`, the exporter's scrape of a live cluster, the launch queue's
asok through the `ceph_cli` three-word fold)."""

import contextlib
import copy
import io
import json
import re
import time

import numpy as np
import pytest

from ceph_tpu.tools import ceph_cli as jcli
from ceph_tpu.tools import latency as jlat
from ceph_tpu.tools import metrics_exporter as jexp
from ceph_tpu.tools.vstart import Cluster as JCluster
from ceph_tpu_torch.tools import ceph_cli as tcli
from ceph_tpu_torch.tools import latency as tlat
from ceph_tpu_torch.tools import metrics_exporter as texp
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

PG_LEDGER = ported("test_pg_ledger")
FOUNDATIONS = ported("test_foundations")
LAUNCH_QUEUE = ported("test_launch_queue")


@pytest.mark.parametrize("case", [
    "test_cluster_kill_revive_ledger_and_surfaces",
    "test_progress_recovery_event_reaches_completion",
    "test_progress_module_baseline_monotone_unit"])
def test_pg_ledger_tools_replay(case, tmp_path):
    run_case(PG_LEDGER, case, tmp_path=tmp_path)


def test_metrics_exporter_scrape_replay(tmp_path):
    run_case(FOUNDATIONS, "test_metrics_exporter_scrape", tmp_path=tmp_path)


def test_launch_queue_asok_replay(tmp_path):
    run_case(LAUNCH_QUEUE, "test_cluster_default_wiring_and_asok",
             tmp_path=tmp_path)


# -- latency ------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.99, 1.1])
def test_zipf_sampler_draws_the_reference_sequence(alpha):
    j, t = jlat.ZipfSampler(1000, alpha, seed=5), \
        tlat.ZipfSampler(1000, alpha, seed=5)
    assert [t.draw() for _ in range(500)] == [j.draw() for _ in range(500)]
    jc, tc = j.spawn(9), t.spawn(9)
    assert [tc.draw() for _ in range(200)] == [jc.draw() for _ in range(200)]
    assert list(tlat.burst_gaps(100.0, 50, 4.0, 10, 3, seed=2)) == \
        list(jlat.burst_gaps(100.0, 50, 4.0, 10, 3, seed=2))


def test_latency_recorder_gives_the_reference_percentiles():
    samples = np.random.default_rng(3).exponential(0.004, 2000)
    j, t = jlat.LatencyRecorder("w"), tlat.LatencyRecorder("w")
    for s in samples:
        j.record(float(s))
        t.record(float(s))
    for rec in (j, t):
        rec.error(TimeoutError())
        rec.error(ValueError())
        rec.error(TimeoutError())
    assert t.summary() == j.summary()
    assert t.summary(unit_ms=False) == j.summary(unit_ms=False)
    assert t.summary()["errors_by_type"] == {"TimeoutError": 2,
                                             "ValueError": 1}


# -- the exporter ---------------------------------------------------------------

def _names_and_types(text: str) -> tuple[set, set]:
    names = {re.split(r"[{ ]", ln, 1)[0] for ln in text.splitlines()
             if ln and not ln.startswith("#")}
    types = {ln for ln in text.splitlines() if ln.startswith("# TYPE")}
    return names, types


def test_exporter_gives_the_reference_names_and_types(tmp_path):
    """Both packages' `collect` over one set of admin sockets (a port
    cluster's mon and OSDs after EC writes) give the same metric names
    and `# TYPE` lines, with each daemon up.  The host's flight recorder
    starts afresh, so that this cluster's first OSD exports its
    launch-latency gauges."""
    from ceph_tpu_torch.ops.profiler import DeviceProfiler
    DeviceProfiler.reset_host()
    with Cluster(n_osds=4, device="cpu", asok_dir=str(tmp_path)) as c:
        cl = c.client()
        cl.set_ec_profile("ex", {"plugin": "torch", "k": "2", "m": "1",
                                 "technique": "cauchy"})
        cl.create_pool("exp", "erasure", erasure_code_profile="ex",
                       pg_num=4)
        ioc = cl.open_ioctx("exp")
        for i in range(4):
            ioc.write_full(f"x{i}", bytes([i]) * 5000)
        c.wait_active_clean(timeout=60)
        t_text = texp.collect(str(tmp_path))
        j_text = jexp.collect(str(tmp_path))
    assert _names_and_types(t_text) == _names_and_types(j_text)
    for d in ("mon.0", "osd.0", "osd.1", "osd.2", "osd.3"):
        assert f'ceph_tpu_daemon_up{{daemon="{d}"}} 1' in t_text
    assert "# TYPE ceph_tpu_lat_launch_device_p99 gauge" in t_text
    assert "ceph_tpu_pg_state{" in t_text


def test_exporter_once_cli(tmp_path, capsys):
    with Cluster(n_osds=2, device="cpu", asok_dir=str(tmp_path)):
        assert texp.main(["--asok-dir", str(tmp_path), "--once"]) == 0
    out = capsys.readouterr().out
    assert 'ceph_tpu_daemon_up{daemon="osd.1"} 1' in out


# -- ceph_cli -------------------------------------------------------------------

def _cli(cli, c, words):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-m", "%s:%d" % tuple(c.mon.addr), *words])
    return rc, json.loads(out.getvalue())


@pytest.fixture(scope="module")
def twin_clusters():
    """A reference cluster and a port cluster built alike: 4 OSDs, an
    EC pool of k=2 m=1 on each package's card plugin, a replicated
    pool, active+clean.

    Both start from the same state: each package's host flight recorder
    is dropped first.  The first OSD to boot on a recorder ships the
    recorder's 60 s window of jit compiles to the mon (COMPILE_STORM),
    so a recorder left by an earlier test of this process, with that
    test's compiles in its window and no OSD yet, would warn in the
    reference cluster's `health` under load; the port's plain versions
    compile nothing."""
    from ceph_tpu.ops.profiler import DeviceProfiler as JProfiler
    from ceph_tpu_torch.ops.profiler import DeviceProfiler
    JProfiler.reset_host()
    DeviceProfiler.reset_host()
    with JCluster(n_osds=4) as jc, Cluster(n_osds=4, device="cpu") as tc:
        for c, plugin in ((jc, "jax"), (tc, "torch")):
            cl = c.client()
            cl.set_ec_profile("p", {"plugin": plugin, "k": "2", "m": "1",
                                    "technique": "cauchy"})
            cl.create_pool("e", "erasure", erasure_code_profile="p",
                           pg_num=8)
            cl.create_pool("r", "replicated", size=2, pg_num=8)
            c.wait_active_clean(timeout=60)
        yield jc, tc


# the port's `pg stat` carries two keys more (the process cluster's
# active+clean wait reads them)
PORT_PG_STAT_KEYS = {"osd_epochs", "recovery_running"}


@pytest.mark.parametrize("words", [
    ["status"], ["health"], ["osd", "tree"], ["pg", "stat"], ["mon", "stat"],
    ["osd", "pool", "ls"], ["osd", "erasure-code-profile", "ls"]],
    ids=lambda w: "_".join(w))
def test_ceph_cli_answers_as_the_reference(twin_clusters, words):
    jc, tc = twin_clusters
    jrc, jout = _cli(jcli, jc, words)
    trc, tout = _cli(tcli, tc, words)
    assert trc == jrc == 0
    if words == ["pg", "stat"]:
        assert set(tout) - set(jout) == PORT_PG_STAT_KEYS
        tout = {k: v for k, v in tout.items() if k not in PORT_PG_STAT_KEYS}
    assert tout == jout


# -- `health` on the same reports ---------------------------------------------

HEALTH_NOW = 1_700_000_000.0

# below the thresholds or stale, in every case: they must raise nothing
HEALTH_NOISE = {
    "slow": {7: {"count": 3, "total_slow": 3, "oldest_age": 9.0,
                 "ops": [], "ts": HEALTH_NOW - 121.0}},
    "pg": {
        5: {"degraded_pgs": 4, "ts": HEALTH_NOW - 11.0},
        6: {"degraded_pgs": 0, "misplaced": 0, "unfound": 0,
            "compile": {"window_s": 60.0, "compile_s": 4.9, "stalls": 3,
                        "worst_bucket": "x:xla:w4096:r2", "worst_s": 2.0,
                        "budget_s": 5.0},
            "msgr": {"window_s": 30.0, "lag_events": 1,
                     "worst_lag_s": 0.5, "worst_reactor": 0,
                     "warn_s": 1.0},
            "ts": HEALTH_NOW - 1.0}},
}

HEALTH_REPORTS = {
    "SLOW_OPS": ("slow", {
        0: {"count": 2, "total_slow": 5, "oldest_age": 42.5, "ops": [
            {"type": "osd_op", "desc": "write o1", "age": 42.5,
             "blamed_stage": "ec_batch_wait", "trace_id": "t1",
             "primary": 2},
            {"type": "osd_op", "desc": "read o2", "age": 12.0,
             "blamed_stage": "launch_device", "trace_id": "t2"}],
            "ts": HEALTH_NOW - 1.0},
        1: {"count": 1, "total_slow": 1, "oldest_age": 3.25,
            "ts": HEALTH_NOW - 2.0}}),
    "PG_DEGRADED": ("pg", {
        1: {"degraded_pgs": 3, "misplaced": 4, "unfound": 1,
            "ledger": {"degraded_oldest_since": HEALTH_NOW - 30.25},
            "ts": HEALTH_NOW - 2.0},
        2: {"degraded_pgs": 0, "misplaced": 2, "ts": HEALTH_NOW - 1.0}}),
    "COMPILE_STORM": ("pg", {
        3: {"compile": {"window_s": 60.0, "compile_s": 8.276, "stalls": 9,
                        "worst_bucket": "x:xla:w2048:r1", "worst_s": 1.9,
                        "budget_s": 5.0},
            "ts": HEALTH_NOW - 1.0}}),
    "MSGR_REACTOR_LAG": ("pg", {
        4: {"msgr": {"window_s": 30.0, "lag_events": 4,
                     "worst_lag_s": 1.75, "worst_reactor": 1,
                     "warn_s": 1.0},
            "ts": HEALTH_NOW - 1.0}}),
}


class _FixedClock:
    """The `time` module with `time()` held at one instant."""

    def __init__(self, now: float):
        self.now = now

    def time(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture(scope="module")
def lone_monitors():
    """A reference and a port monitor, each alone on loopback (port 0,
    no OSDs)."""
    from ceph_tpu.mon import Monitor as JMonitor
    from ceph_tpu_torch.mon import Monitor
    jmon, tmon = JMonitor(), Monitor(device="cpu")
    try:
        yield jmon, tmon
    finally:
        jmon.shutdown()
        tmon.shutdown()


@pytest.mark.parametrize("raised", [
    (), ("SLOW_OPS",), ("PG_DEGRADED",), ("COMPILE_STORM",),
    ("MSGR_REACTOR_LAG",),
    ("SLOW_OPS", "PG_DEGRADED", "COMPILE_STORM", "MSGR_REACTOR_LAG")],
    ids=lambda r: "+".join(r) or "none")
def test_health_checks_equal_on_the_same_reports(lone_monitors, raised,
                                                 monkeypatch):
    """Both monitors' `_cmd_health` on the same injected slow-op and
    pg-stat reports, at the same `time.time`, answer exactly alike and
    raise just the checks the reports call for."""
    import ceph_tpu.mon.monitor as jmod
    import ceph_tpu_torch.mon.monitor as tmod
    slow, pg = dict(HEALTH_NOISE["slow"]), dict(HEALTH_NOISE["pg"])
    for check in raised:
        table, reports = HEALTH_REPORTS[check]
        (slow if table == "slow" else pg).update(reports)
    answers = []
    for mod, mon in zip((jmod, tmod), lone_monitors):
        with mon.lock:
            mon.slow_op_reports.clear()
            mon.slow_op_reports.update(copy.deepcopy(slow))
            mon.pg_stat_reports.clear()
            mon.pg_stat_reports.update(copy.deepcopy(pg))
        with monkeypatch.context() as mp:
            mp.setattr(mod, "time", _FixedClock(HEALTH_NOW))
            answers.append(mon._cmd_health())
    (jrc, jout), (trc, tout) = answers
    assert trc == jrc == 0
    assert tout == jout
    assert tout["status"] == ("HEALTH_WARN" if raised else "HEALTH_OK")
    assert set(tout["checks"]) == set(raised)


def test_fs_commands_list_the_filesystem_and_its_mds(twin_clusters):
    """`_register_fsmap` swallows its errors as the reference's does;
    `fs ls` and `fs dump` on the port's mon show the filesystem and its
    MDS, as the reference's mon does for its MDS."""
    from ceph_tpu.fs import MDSDaemon as JMDS
    from ceph_tpu_torch.fs import MDSDaemon as TMDS
    outs = []
    for c, mds_cls, cli in ((twin_clusters[0], JMDS, jcli),
                            (twin_clusters[1], TMDS, tcli)):
        mds = mds_cls(c.mon_addrs, name="a")
        try:
            _, ls = _cli(cli, c, ["fs", "ls"])
            _, dump = _cli(cli, c, ["fs", "dump"])
        finally:
            mds.shutdown()
        outs.append((ls, dump))
        assert ls == {"filesystems": ["cephfs"]}
        assert "cephfs_data" in json.dumps(dump)
        assert '"a"' in json.dumps(dump)
    strip = re.compile(r'"addr": \["127\.0\.0\.1", \d+\]')
    assert strip.sub("", json.dumps(outs[1], sort_keys=True)) == \
        strip.sub("", json.dumps(outs[0], sort_keys=True))


def test_ceph_cli_daemon_folds_multiword_prefixes(tmp_path, capsys):
    """`ceph daemon ASOK launch profile` (two words) and `launch queue
    status` (three) reach the port OSD's admin socket."""
    with Cluster(n_osds=3, device="cpu", asok_dir=str(tmp_path)):
        asok = str(tmp_path / "osd.0.asok")
        assert tcli.main(["daemon", asok, "launch", "profile"]) == 0
        prof = json.loads(capsys.readouterr().out)
        assert "kernel_launches" in prof
        assert tcli.main(["daemon", asok, "launch", "queue",
                          "status"]) == 0
        assert "enabled" in json.loads(capsys.readouterr().out)
        assert tcli.main(["daemon", asok, "pg", "ledger"]) == 0
        capsys.readouterr()
        assert tcli.main(["daemon", asok, "config", "set",
                          "debug_osd"]) == 22


def test_ceph_cli_usage_names_the_torch_plugin():
    doc = tcli.__doc__
    assert "plugin=torch" in doc and "plugin=jax" not in doc
    assert "python -m ceph_tpu_torch.tools.ceph_cli" in doc

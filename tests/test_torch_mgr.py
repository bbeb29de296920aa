"""The manager on a port cluster on the CPU: tests/test_mgr.py and
tests/test_mgr_modules.py replayed on the port (the health model, the
upmap balancer, the pg autoscaler's recommendations, pg-temp, telemetry,
devicehealth's flap check, the dashboard), the health and balancer
cases on the reference's jerasure EC pool and on a torch one; and the
balancer's moves and the mon's upmap held against the reference's on
equal clusters."""

import pytest

from ceph_tpu_torch.mgr import MgrDaemon, MgrModule
from ceph_tpu_torch.mgr.modules import (DEFAULT_MODULES, BalancerModule,
                                        DashboardModule, HealthModule,
                                        TelemetryModule)
from ceph_tpu_torch.tools.vstart import Cluster
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

MGR = ported("test_mgr")
MGR_MODULES = ported("test_mgr_modules")


@pytest.fixture(scope="module", params=["jerasure", "torch"])
def env(request):
    """The reference's env (5 OSDs, an EC pool `mgp` of k=2 m=1 and a
    mgr with the default modules), its pool on `request.param`."""
    with Cluster(n_osds=5, device="cpu") as c:
        client = c.client()
        client.set_ec_profile("mg", {"plugin": request.param, "k": "2",
                                     "m": "1"})
        client.create_pool("mgp", "erasure", erasure_code_profile="mg",
                           pg_num=8)
        mgr = MgrDaemon(c.mon_addrs).start()
        yield c, client, mgr
        mgr.shutdown()


@pytest.mark.parametrize("case", [
    "test_health_ok_then_warn_on_osd_down",
    "test_balancer_reduces_spread",
    "test_pg_autoscaler_recommends_power_of_two",
    "test_mon_pg_temp_roundtrip"])
def test_mgr_replay(env, case):
    run_case(MGR, case, env=env)


@pytest.fixture(scope="module")
def modules_env():
    """The reference's test_mgr_modules env: 4 OSDs with heartbeats, a
    replicated pool, a mgr with health, telemetry, devicehealth and the
    dashboard."""
    from ceph_tpu_torch.mgr.modules import DeviceHealthModule
    with Cluster(n_osds=4, heartbeat_interval=0.25, device="cpu") as c:
        client = c.client()
        client.create_pool("mgx", pg_num=8, size=2)
        mgr = MgrDaemon(c.mon_addrs, modules=[
            HealthModule, TelemetryModule, DeviceHealthModule,
            DashboardModule]).start()
        yield c, client, mgr
        mgr.shutdown()


@pytest.mark.parametrize("case", [
    "test_telemetry_report",
    "test_devicehealth_flags_flapping_osd",
    "test_dashboard_endpoints"])
def test_mgr_modules_replay(modules_env, case, tmp_path):
    run_case(MGR_MODULES, case, env=modules_env, tmp_path=tmp_path)


def test_default_modules_match_the_reference():
    from ceph_tpu.mgr import MgrModule as JModule
    from ceph_tpu.mgr.modules import DEFAULT_MODULES as JDEFAULT
    assert [m.name for m in DEFAULT_MODULES] == \
        [m.name for m in JDEFAULT] == \
        ["health", "balancer", "pg_autoscaler", "telemetry",
         "devicehealth", "progress", "rgw_reshard"]
    assert [m.run_interval for m in DEFAULT_MODULES] == \
        [m.run_interval for m in JDEFAULT]
    assert issubclass(DashboardModule, MgrModule)
    assert MgrModule.__name__ == JModule.__name__


def _up_sets(osdmap, pg_t):
    return {(p.name, seed): osdmap.pg_to_up_acting_osds(
        pg_t(p.id, seed))[0]
        for p in osdmap.pools.values() for seed in range(p.pg_num)}


def test_balancer_and_upmap_match_the_reference():
    """Equal clusters, the same skew forced with `osd pg-upmap-items`
    on both mons: the same up sets; both balancers propose the same
    moves, and each mon applies them to the same up sets."""
    from ceph_tpu.mgr.modules import BalancerModule as JBalancer
    from ceph_tpu.osd.types import pg_t as jpg_t
    from ceph_tpu.tools.vstart import Cluster as JCluster
    from ceph_tpu_torch.osd.types import pg_t as tpg_t
    with JCluster(n_osds=6) as jc, Cluster(n_osds=6, device="cpu") as tc:
        sides = ((jc, jpg_t, JBalancer), (tc, tpg_t, BalancerModule))
        clients = []
        for c, pg_t, _ in sides:
            cl = c.client()
            clients.append(cl)
            cl.create_pool("bal", "replicated", size=3, pg_num=16)
            pool = c.mon.osdmap.lookup_pool("bal")
            for seed in range(6):
                raw = c.mon.osdmap.pg_to_raw_osds(pg_t(pool.id, seed))
                pairs = [[o, t] for o, t in zip(raw, [0, 1, 2])
                         if o != t and t not in raw]
                if pairs:
                    r, _ = cl.mon_command({
                        "prefix": "osd pg-upmap-items",
                        "pgid": [pool.id, seed], "pairs": pairs})
                    assert r == 0
        assert _up_sets(tc.mon.osdmap, tpg_t) == \
            _up_sets(jc.mon.osdmap, jpg_t)
        moves = []
        for (c, _, bal_cls), cl in zip(sides, clients):
            bal = bal_cls(type("Mgr", (), {"osdmap": c.mon.osdmap})())
            got = bal.compute_moves()
            moves.append(sorted((p.pool, p.seed, pairs)
                                for p, pairs in got))
            for p, pairs in got:
                r, _ = cl.mon_command({
                    "prefix": "osd pg-upmap-items",
                    "pgid": [p.pool, p.seed],
                    "pairs": [list(x) for x in pairs]})
                assert r == 0
        assert moves[0] == moves[1] and moves[0]
        assert _up_sets(tc.mon.osdmap, tpg_t) == \
            _up_sets(jc.mon.osdmap, jpg_t)

"""CRUSH and the OSDMap of the port against the JAX package's.

The same cluster layout and pools built in both packages must place
every object on the same PG and every PG on the same up and acting
sets, and an Incremental chain (OSDs going down and out, pg_num
changes, pg_temp and upmap entries) must apply to the same map in both,
crossing between them through its JSON form.  A few cases of
tests/test_crush.py and tests/test_osdmap_inc.py replay on the port."""

import json

import numpy as np
import pytest

import ceph_tpu.crush.hash as jhash
import ceph_tpu.osd.osd_map as jmap
import ceph_tpu.osd.types as jtypes
import ceph_tpu_torch.crush.hash as thash
import ceph_tpu_torch.osd.osd_map as tmap
import ceph_tpu_torch.osd.types as ttypes
from test_torch_cluster_foundations import (  # noqa: F401
    port_singletons, ported, run_case)

PORT = (tmap, ttypes)
REF = (jmap, jtypes)
N_OBJECTS = 10_000


def build_map(pkg, n_hosts=7, per_host=2):
    """An OSDMap of n_hosts x per_host OSDs (every third OSD at half
    weight), a replicated pool of size 3 and an EC pool of 6 shards
    (indep rule), as a cluster of that layout would hold it."""
    om, ty = pkg
    m = om.OSDMap()
    osd = 0
    for h in range(n_hosts):
        for _ in range(per_host):
            m.add_osd(osd, f"host{h}", weight=0.5 if osd % 3 == 0 else 1.0,
                      addr=("127.0.0.1", 7000 + osd))
            m.set_osd_up(osd)
            osd += 1
    rep = m.crush.add_simple_rule("rep", "default", "host", 3)
    ec = m.crush.add_simple_rule("ec", "default", "host", 6,
                                 rule_mode="indep")
    m.create_pool("rbd", ty.PoolType.REPLICATED, size=3, pg_num=64,
                  crush_rule=rep)
    m.create_pool("ecpool", ty.PoolType.ERASURE, size=6, pg_num=32,
                  crush_rule=ec, stripe_width=4 * 4096)
    m.bump_epoch()
    return m


def placements(m, ty, names):
    """{pool: [(seed, up, acting, up_primary, acting_primary)]} for
    every object name."""
    out = {}
    for pool in sorted(m.pools):
        cache = {}
        rows = []
        for name in names:
            pg = m.object_to_pg(pool, name)
            if pg.seed not in cache:
                cache[pg.seed] = m.pg_to_up_acting_osds(
                    ty.pg_t(pool, pg.seed))
            rows.append((pg.seed, cache[pg.seed]))
        out[pool] = rows
    return out


@pytest.fixture(scope="module")
def names():
    rng = np.random.default_rng(20)
    return [f"rbd_data.{rng.integers(1 << 40):x}.{i:016x}"
            for i in range(N_OBJECTS)]


def test_crush_hash_matches_reference():
    rng = np.random.default_rng(1)
    for a, b, c in rng.integers(0, 1 << 32, (500, 3), dtype=np.uint64):
        a, b, c = int(a), int(b), int(c)
        for args in ((a,), (a, b), (a, b, c)):
            assert thash.crush_hash32(*args) == jhash.crush_hash32(*args)
            assert thash.crush_unit_interval(*args) == \
                jhash.crush_unit_interval(*args)


def test_placement_matches_reference(names):
    tm, jm = build_map(PORT), build_map(REF)
    assert tm.canonical() == jm.canonical()
    assert placements(tm, ttypes, names) == placements(jm, jtypes, names)
    # an OSD down, another out: the same holes and the same remaps
    for m in (tm, jm):
        m.set_osd_down(3)
        m.set_osd_out(8)
        m.bump_epoch()
    assert placements(tm, ttypes, names) == placements(jm, jtypes, names)


def _mutations(pkg):
    """One churn step after another, each a function of the map."""
    om, ty = pkg
    return [
        lambda m: m.set_osd_down(5),
        lambda m: m.set_osd_out(5),
        lambda m: m.set_pool_pg_num(1, 128),
        lambda m: m.set_osd_weight(2, 0.25),
        lambda m: m.pg_temp.__setitem__(ty.pg_t(2, 3), [0, 1, 2, 3, 4, 6]),
        lambda m: m.pg_upmap_items.__setitem__(ty.pg_t(1, 7), [(0, 9)]),
        lambda m: m.set_osd_up(5),
        lambda m: m.set_pool_pg_num(1, 64),
        lambda m: m.remove_osd(13),
        lambda m: m.ec_profiles.__setitem__(
            "p", {"plugin": "torch", "k": "4", "m": "2"}),
    ]


def test_incremental_chain_crosses_packages(names):
    """Each step diffs in one package and applies in the other through
    the JSON wire form, and apply_inc_chain replays the whole chain."""
    maps = {"port": build_map(PORT), "ref": build_map(REF)}
    mods = {"port": tmap, "ref": jmap}
    start = {k: mods[k].OSDMap.from_json(m.to_json())
             for k, m in maps.items()}
    incs = {"port": [], "ref": []}
    for step, (t_mut, j_mut) in enumerate(zip(_mutations(PORT),
                                              _mutations(REF))):
        olds = {k: m.to_json() for k, m in maps.items()}
        t_mut(maps["port"])
        j_mut(maps["ref"])
        for m in maps.values():
            m.bump_epoch()
        for src, dst in (("port", "ref"), ("ref", "port")):
            inc = mods[src].Incremental.diff(olds[src],
                                             maps[src].to_json())
            wire = json.loads(json.dumps(inc.to_json()))
            incs[dst].append(wire)
            applied = mods[dst].OSDMap.from_json(olds[dst]) \
                .apply_incremental(mods[dst].Incremental.from_json(wire))
            assert applied.canonical() == maps[dst].canonical(), step
        assert maps["port"].canonical() == maps["ref"].canonical(), step
    for k, m in maps.items():
        got = mods[k].apply_inc_chain(start[k], incs[k])
        assert got is not None and got.canonical() == m.canonical()
    assert placements(maps["port"], ttypes, names[:2000]) == \
        placements(maps["ref"], jtypes, names[:2000])


def test_validate_pg_num_step_matches_reference():
    for cur, new in [(8, 16), (8, 8), (16, 8), (8, 512), (8, 12), (64, 1),
                     (1, 0)]:
        outs = []
        for mod in (tmap, jmap):
            try:
                mod.validate_pg_num_step(cur, new)
                outs.append(None)
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], (cur, new)


CRUSH = ported("test_crush")


@pytest.mark.parametrize("case", [
    "test_deterministic", "test_failure_domain_separation",
    "test_indep_positional_stability",
    "test_indep_returns_positional_holes_when_scarce",
    "test_osdmap_ec_pool_mapping", "test_osdmap_replicated_pool_compacts",
    "test_object_to_pg_stable", "test_pg_temp_override"])
def test_crush_replay(case):
    run_case(CRUSH, case)


OSDMAP_INC = ported("test_osdmap_inc")


@pytest.fixture()
def mon():
    m = OSDMAP_INC.Monitor(device="cpu")
    yield m
    m.shutdown()


@pytest.mark.parametrize("case", [
    "test_incremental_roundtrip_pure_map",
    "test_incremental_vs_full_equivalence_per_epoch",
    "test_gap_recovery_serves_full",
    "test_mixed_version_fallback_always_full",
    "test_boot_burst_batches_epochs"])
def test_osdmap_inc_replay(case, request):
    fixtures = {}
    if "mon" in OSDMAP_INC.__dict__[case].__code__.co_varnames:
        fixtures["mon"] = request.getfixturevalue("mon")
    run_case(OSDMAP_INC, case, **fixtures)

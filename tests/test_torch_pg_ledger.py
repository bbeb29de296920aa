"""The port's control-plane flight recorder (ceph_tpu_torch/osd/
pg_ledger.py): the unit tests of tests/test_pg_ledger.py (the ledger
core, before its cluster tests) run on the port's module and on the
JAX package's, and one seeded run of transitions through both must
leave the same dumps, blame blocks and state counts."""

import time

import numpy as np
import pytest

import ceph_tpu.osd.pg_ledger as jledger
import ceph_tpu.osd.types as jtypes
import ceph_tpu_torch.osd.pg_ledger as tledger
import ceph_tpu_torch.osd.types as ttypes


class _Side:
    def __init__(self, ledger, types):
        self.NULL_STAGE = ledger.NULL_STAGE
        self.STAGES = ledger.STAGES
        self.PGLedger = ledger.PGLedger
        self.pg_t = types.pg_t


@pytest.fixture(params=["port", "reference"])
def side(request):
    if request.param == "port":
        return _Side(tledger, ttypes)
    return _Side(jledger, jtypes)


def _wait(pred, timeout=30.0, step=0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


# -- ledger core -------------------------------------------------------------

def test_ring_bounded_and_seqs_monotonic(side):
    """Transitions across several PGs: each ring evicts to maxlen,
    seqs are daemon-wide monotonic (one total order over all PGs),
    and the previous state's duration rides each entry."""
    led = side.PGLedger("pg_ledger.t1", ring=4)
    pgs = [side.pg_t(1, 0), side.pg_t(1, 1), side.pg_t(2, 0)]
    for i in range(12):
        led.transition(pgs[i % 3], f"s{i}", epoch=i + 1)
    d = led.dump(last=None)
    assert d["enabled"] and d["ring_size"] == 4
    all_seqs = []
    for pgid in pgs:
        trans = d["pgs"][str(pgid)]["transitions"]
        assert len(trans) == 4                    # ring evicted
        assert all(t["dur_s"] >= 0.0 for t in trans)
        all_seqs += [t["seq"] for t in trans]
    assert len(set(all_seqs)) == len(all_seqs)    # globally unique
    # per-PG rings are each internally ordered by the global seq
    for pgid in pgs:
        seqs = [t["seq"] for t in d["pgs"][str(pgid)]["transitions"]]
        assert seqs == sorted(seqs)
    assert max(all_seqs) == 12
    assert d["totals"]["transitions"] == 12
    assert led.perf.dump()["pg_transitions"] == 12
    # epoch of the latest transition sticks to the record
    assert d["pgs"][str(pgs[0])]["epoch"] == 10


def test_disabled_null_path_records_nothing(side):
    """enabled=False: every entry point no-ops after one attribute
    check, stage() hands back the shared null context manager, and
    the pgstats block stays None."""
    led = side.PGLedger("pg_ledger.t2", ring=4)
    led.enabled = False
    pg = side.pg_t(1, 0)
    led.transition(pg, "peering")
    led.count(pg, "remote_lists", 5)
    led.degraded_open(pg)
    led.degraded_ack(pg)
    assert led.degraded_close(pg) is False
    s = led.stage(pg, "scan")
    assert s is side.NULL_STAGE
    with s:
        pass
    t = led.totals()
    assert t["transitions"] == 0 and t["remote_lists"] == 0
    assert t["degraded_open"] == 0 and t["degraded_acked"] == 0
    assert led.pgstats_block() is None
    assert led.perf.dump()["pg_transitions"] == 0
    assert led.dump()["pgs"] == {}


def test_degraded_window_closes_exactly_once(side):
    """degraded_ack opens the window; only the FIRST close ends it
    (clean recovery passes close redundantly every cycle); the open
    gauge returns to zero and the window duration lands in
    lat_degraded_window exactly once."""
    led = side.PGLedger("pg_ledger.t3")
    pg = side.pg_t(3, 1)
    assert led.degraded_close(pg) is False       # never opened
    led.degraded_ack(pg)
    led.degraded_ack(pg)                          # still ONE window
    t = led.totals()
    assert t["degraded_open"] == 1
    assert t["degraded_acked"] == 2
    assert t["degraded_oldest_since"] is not None
    assert led.perf.dump()["pg_degraded_open_windows"] == 1
    assert led.degraded_close(pg) is True
    for _ in range(3):                            # redundant closes
        assert led.degraded_close(pg) is False
    t = led.totals()
    assert t["degraded_windows"] == 1
    assert t["degraded_open"] == 0
    assert t["degraded_oldest_since"] is None
    d = led.perf.dump()
    assert d["pg_degraded_open_windows"] == 0
    assert d["pg_degraded_windows"] == 1
    assert led.perf.dump_latencies()["lat_degraded_window"][
        "count"] == 1
    # a second episode is a fresh window
    led.degraded_open(pg)
    assert led.degraded_close(pg) is True
    assert led.totals()["degraded_windows"] == 2


def test_stage_timing_counters_and_blame_block(side):
    """The stage context manager accumulates per-PG wall seconds into
    the right histogram axis (peering -> lat_peering_total, the rest
    -> lat_recovery_*), counters sum daemon-wide, and blame_block
    carries the full decomposition cluster_bench diffs."""
    led = side.PGLedger("pg_ledger.t4")
    pg = side.pg_t(1, 0)
    for name in side.STAGES:
        with led.stage(pg, name):
            time.sleep(0.002)
    led.count(pg, "remote_lists", 3)
    led.count(pg, "objects_scanned", 7)
    led.count(pg, "objects_recovered", 2)
    led.transition(pg, "recovering")
    t = led.totals()
    for name in side.STAGES:
        assert t[f"{name}_s"] > 0.0, name
    assert t["remote_lists"] == 3 and t["objects_scanned"] == 7
    lat = led.perf.dump_latencies()
    assert lat["lat_peering_total"]["count"] == 1
    for name in ("scan", "decode", "push", "throttle"):
        assert lat[f"lat_recovery_{name}"]["count"] == 1, name
    blame = led.blame_block()
    assert set(blame) == {
        "peering_s", "scan_s", "decode_s", "push_s", "throttle_s",
        "remote_lists", "objects_scanned", "objects_recovered",
        "transitions", "degraded_windows", "degraded_acked"}
    assert blame["transitions"] == 1
    assert blame["objects_recovered"] == 2


def test_pgstats_block_empty_then_stable(side):
    """None while nothing happened (boot reports stay lean), then a
    cumulative block whose repr is bit-identical between quiescent
    stat windows — the property the MPGStats keepalive dedup needs."""
    led = side.PGLedger("pg_ledger.t5")
    assert led.pgstats_block() is None
    pg = side.pg_t(4, 0)
    led.transition(pg, "active", epoch=3)
    b1 = led.pgstats_block()
    assert b1 is not None and b1["transitions"] == 1
    assert b1["degraded_oldest_since"] is None
    assert led.pgstats_block() == b1              # quiescent == stable
    led.degraded_ack(pg)
    b2 = led.pgstats_block()
    assert b2 != b1 and b2["degraded_open"] == 1
    assert b2["degraded_acked"] == 1


def test_pg_state_counts_and_ring_resize(side):
    led = side.PGLedger("pg_ledger.t6", ring=8)
    led.transition(side.pg_t(1, 0), "active")
    led.transition(side.pg_t(1, 1), "active")
    led.transition(side.pg_t(2, 0), "peering")
    led.degraded_ack(side.pg_t(1, 1))
    counts = led.pg_state_counts()
    assert counts[1]["active"] == 2
    assert counts[2]["peering"] == 1
    assert counts[1]["degraded"] == 1             # pseudo-state
    for _ in range(6):
        led.transition(side.pg_t(1, 0), "thrash")
    led.set_ring_size(2)
    d = led.dump(last=None)
    assert all(len(p["transitions"]) <= 2 for p in d["pgs"].values())


# -- cluster: transitions, asok, MPGStats, exporter --------------------------


def _ledger_run(ledger, types, seed):
    """A seeded run of transitions, counted work and degraded windows;
    returns the clock-free parts of the ledger's surfaces."""
    rng = np.random.default_rng(seed)
    led = ledger.PGLedger(ring=6)
    states = ("peering", "active", "active+recovering", "active+clean",
              "active+degraded")
    pgs = [types.pg_t(1, i) for i in range(4)]
    for i in range(60):
        pg = pgs[int(rng.integers(0, len(pgs)))]
        op = int(rng.integers(0, 5))
        if op < 2:
            led.transition(pg, states[int(rng.integers(0, len(states)))],
                           epoch=i)
        elif op == 2:
            led.count(pg, ("remote_lists", "objects_scanned",
                           "objects_recovered")[i % 3], i % 4 + 1)
        elif op == 3:
            led.degraded_open(pg)
            if rng.random() < 0.5:
                led.degraded_ack(pg)
        else:
            led.degraded_close(pg)
    dump = led.dump(last=None)
    pgd = {k: {"state": v["state"], "epoch": v["epoch"],
               "counters": v["counters"],
               "windows": v["degraded"]["windows"],
               "acked": v["degraded"]["acked_writes"],
               "open": v["degraded"]["open_since"] is not None,
               "transitions": [(t["seq"], t["epoch"], t["from"], t["to"])
                               for t in v["transitions"]]}
           for k, v in dump["pgs"].items()}
    totals = {k: v for k, v in led.totals().items()
              if not k.endswith("_s") and k != "degraded_oldest_since"}
    return pgd, totals, led.pg_state_counts()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_run_same_ledger_as_reference(seed):
    assert _ledger_run(tledger, ttypes, seed) == \
        _ledger_run(jledger, jtypes, seed)

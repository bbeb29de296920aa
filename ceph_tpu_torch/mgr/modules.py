"""Built-in mgr modules: health, balancer, pg_autoscaler, telemetry,
devicehealth, dashboard.

Reference analogs: the mgr health aggregation (src/mgr/DaemonHealth*),
pybind/mgr/balancer (upmap mode re-expressed over pg_temp, the map's
explicit acting-set override), and pybind/mgr/pg_autoscaler (advisory
by default; pools that opt in with pg_autoscale_mode=on get real
pg_num increases issued through the mon, which the OSDs execute as
live PG splits).
"""

from __future__ import annotations

import threading

from ..crush.map import CRUSH_ITEM_NONE
from ..osd.types import pg_t
from .daemon import MgrModule


class HealthModule(MgrModule):
    """Cluster health from the map: down/out OSDs, PGs below size."""

    name = "health"
    run_interval = 0.5

    def tick(self) -> None:
        m = self.get_osdmap()
        warns: list[str] = []
        errs: list[str] = []
        down = [o.id for o in m.osds.values() if not o.up]
        if down:
            warns.append(f"{len(down)} osds down: {down}")
        degraded = 0
        unavailable = 0
        for pool in m.pools.values():
            for seed in range(pool.pg_num):
                try:
                    _, acting, _, _ = m.pg_to_up_acting_osds(
                        pg_t(pool.id, seed))
                except Exception:  # noqa: BLE001
                    continue
                live = sum(1 for o in acting
                           if o != CRUSH_ITEM_NONE and m.is_up(o))
                if live < pool.min_size:
                    unavailable += 1
                elif live < pool.size:
                    degraded += 1
        if degraded:
            warns.append(f"{degraded} pgs degraded")
        if unavailable:
            errs.append(f"{unavailable} pgs below min_size")
        status = "HEALTH_ERR" if errs else (
            "HEALTH_WARN" if warns else "HEALTH_OK")
        self.mgr.set_health(self.name, status, errs + warns)


class BalancerModule(MgrModule):
    """Even the PG->OSD distribution with pg_upmap_items (the upmap
    balancer; reference pybind/mgr/balancer upmap mode over
    OSDMap::calc_pg_upmaps).  Greedy: substitute one device at a time
    on the most-loaded OSD's PGs toward the least-loaded OSD until the
    spread is within threshold.  Upmap items override the RAW crush
    result per PG, so they compose with CRUSH and survive remaps of
    unrelated devices — unlike the pg_temp acting-set override, which
    stays the peering/backfill lever."""

    name = "balancer"
    run_interval = 2.0
    max_moves_per_tick = 4
    threshold = 1          # max-min PG count gap considered balanced

    def __init__(self, mgr):
        super().__init__(mgr)
        self.active = True
        self.moves = 0

    def compute_moves(self) -> list[tuple[pg_t, list[tuple[int, int]]]]:
        """-> [(pgid, upmap pairs for that pg)] — the calc_pg_upmaps
        role."""
        m = self.get_osdmap()
        up_osds = [o.id for o in m.osds.values() if o.up and o.in_]
        if len(up_osds) < 2:
            return []
        load: dict[int, int] = {o: 0 for o in up_osds}
        # positional raw+upmap lists (NOT the compacted up set: zip
        # alignment with the raw crush result must hold even when a
        # raw-set OSD is down)
        placement: dict[pg_t, list[int]] = {}
        for pool in m.pools.values():
            for seed in range(pool.pg_num):
                pgid = pg_t(pool.id, seed)
                try:
                    cur = m.pg_to_raw_upmap_osds(pgid)
                except Exception:  # noqa: BLE001
                    continue
                placement[pgid] = list(cur)
                for o in cur:
                    if o in load:
                        load[o] += 1
        touched: set[pg_t] = set()
        for _ in range(self.max_moves_per_tick):
            hot = max(load, key=load.get)
            cold = min(load, key=load.get)
            if load[hot] - load[cold] <= self.threshold:
                break
            # one PG mapped onto `hot` whose up set lacks `cold`
            for pgid, up in placement.items():
                if hot in up and cold not in up:
                    placement[pgid] = [cold if o == hot else o
                                       for o in up]
                    touched.add(pgid)
                    load[hot] -= 1
                    load[cold] += 1
                    break
            else:
                break
        # emit each touched PG's items as the POSITIONAL diff of the
        # raw crush result vs the desired placement — a simultaneous
        # substitution map with no chains (how calc_pg_upmaps emits)
        out = []
        for pgid in touched:
            raw = m.pg_to_raw_osds(pgid)
            pairs = sorted((o, d) for o, d in
                           zip(raw, placement[pgid]) if o != d)
            out.append((pgid, pairs))
        return out

    def tick(self) -> None:
        if not self.active:
            return
        for pgid, pairs in self.compute_moves():
            r, _ = self.mon_command({
                "prefix": "osd pg-upmap-items",
                "pgid": [pgid.pool, pgid.seed],
                "pairs": [list(p) for p in pairs]})
            if r == 0:
                self.moves += 1


class PgAutoscalerModule(MgrModule):
    """Recommend — and, for opted-in pools, APPLY — pg_num per pool
    (reference pybind/mgr/pg_autoscaler): target ~quarter of the
    reference's 100 PGs per OSD, power of two.

    Pools default to advisory mode (a health warning when far off).
    A pool with pg_autoscale_mode=on (`ceph osd pool set <pool>
    pg_autoscale_mode on`) gets real `osd pool set pg_num` commands
    in BOTH directions: the mon commits the change through Paxos and
    the OSDs split or merge the PGs live.  Stepped at most `max_step`x
    per tick so one tick never floods the cluster with every split or
    merge at once; a decrease the mon refuses (split still settling —
    the interleave guard) simply retries on a later tick."""

    name = "pg_autoscaler"
    run_interval = 2.0
    target_pgs_per_osd = 32
    max_step = 4           # per-tick resize factor cap (power of two)

    def recommendations(self) -> dict[str, int]:
        m = self.get_osdmap()
        n_osds = sum(1 for o in m.osds.values() if o.up and o.in_)
        if not n_osds or not m.pools:
            return {}
        budget = n_osds * self.target_pgs_per_osd
        per_pool = max(1, budget // max(1, len(m.pools)))
        rec = 1 << (per_pool.bit_length() - 1)   # floor power of two
        return {p.name: rec for p in m.pools.values()}

    def tick(self) -> None:
        m = self.get_osdmap()
        recs = self.recommendations()
        warns = []
        for p in m.pools.values():
            want = recs.get(p.name, p.pg_num)
            mode = getattr(p, "pg_autoscale_mode", "warn")
            if mode == "on" and want != p.pg_num and p.pg_num and \
                    p.pg_num & (p.pg_num - 1) == 0:
                if want > p.pg_num:
                    target = min(want, p.pg_num * self.max_step)
                elif want * 4 <= p.pg_num:
                    # scale DOWN too (PG merge): capped step, and only
                    # past a 4x hysteresis band — a transiently-down
                    # OSD shrinking the recommendation must not
                    # trigger merge/split thrash.  The mon rejects
                    # with EBUSY while a split is settling (interleave
                    # guard) — retry next tick.
                    target = max(want, max(1,
                                           p.pg_num // self.max_step))
                else:
                    target = p.pg_num   # inside the band: leave it
                if target != p.pg_num:
                    r, _out = self.mon_command({
                        "prefix": "osd pool set", "pool": p.name,
                        "var": "pg_num", "val": str(target)})
                    if r == 0:
                        continue   # acted; re-evaluate next tick
            if want >= 4 * p.pg_num or p.pg_num >= 4 * want:
                warns.append(
                    f"pool {p.name!r} pg_num {p.pg_num} far from "
                    f"recommended {want}")
        self.mgr.set_health(
            self.name,
            "HEALTH_WARN" if warns else "HEALTH_OK", warns)


class TelemetryModule(MgrModule):
    """Periodic anonymized cluster report (reference pybind/mgr/
    telemetry — there it phones home; here the report is exposed on
    the module and, when a report path is set, written as JSON for an
    operator to forward)."""

    name = "telemetry"
    run_interval = 5.0
    report_path: str | None = None       # set by operator/tests

    def __init__(self, mgr):
        super().__init__(mgr)
        self.last_report: dict | None = None

    def compile_report(self) -> dict:
        import time as _time
        m = self.get_osdmap()
        pools = list(m.pools.values())
        return {
            "report_timestamp": _time.time(),
            "osdmap_epoch": m.epoch,
            "osds": {"total": len(m.osds),
                     "up": sum(1 for o in m.osds.values() if o.up),
                     "in": sum(1 for o in m.osds.values() if o.in_)},
            "pools": {"total": len(pools),
                      "replicated": sum(1 for p in pools
                                        if not p.is_erasure()),
                      "erasure": sum(1 for p in pools
                                     if p.is_erasure()),
                      "pg_total": sum(p.pg_num for p in pools)},
            "ec_profiles": sorted(
                {p.erasure_code_profile for p in pools
                 if p.is_erasure()}),
            "health": self.mgr.health_summary().get("status"),
        }

    def tick(self) -> None:
        self.last_report = self.compile_report()
        if self.report_path:
            import json as _json
            import os as _os
            tmp = self.report_path + ".tmp"
            with open(tmp, "w") as f:      # atomic swap: a reader
                _json.dump(self.last_report, f, indent=2)   # never
            _os.replace(tmp, self.report_path)   # sees partial JSON


class DeviceHealthModule(MgrModule):
    """Failing-device early warning (reference pybind/mgr/devicehealth,
    reduced: no SMART source here, so the signal is FLAPPING — an OSD
    that bounces down repeatedly inside the window is predicted
    unhealthy and surfaced before it dies for good)."""

    name = "devicehealth"
    run_interval = 1.0
    window_s = 600.0
    flap_threshold = 3

    def __init__(self, mgr):
        super().__init__(mgr)
        self._was_up: dict[int, bool] = {}
        self._downs: dict[int, list[float]] = {}

    def tick(self) -> None:
        import time as _time
        m = self.get_osdmap()
        now = _time.time()
        warns = []
        for o in m.osds.values():
            prev = self._was_up.get(o.id)
            if prev is True and not o.up:
                self._downs.setdefault(o.id, []).append(now)
            self._was_up[o.id] = o.up
        for osd_id, downs in self._downs.items():
            recent = [t for t in downs if now - t < self.window_s]
            self._downs[osd_id] = recent
            if len(recent) >= self.flap_threshold:
                warns.append(
                    f"osd.{osd_id} flapped {len(recent)}x in "
                    f"{int(self.window_s)}s: possible failing device")
        self.mgr.set_health(
            self.name, "HEALTH_WARN" if warns else "HEALTH_OK", warns)


class DashboardModule(MgrModule):
    """Read-only cluster dashboard (reference pybind/mgr/dashboard,
    reduced to the observability core): an HTTP endpoint serving an
    HTML summary plus /api/health, /api/osds, /api/pools JSON."""

    name = "dashboard"
    run_interval = 3600.0                # serving is thread-driven
    port = 0                             # 0 = ephemeral

    def __init__(self, mgr):
        super().__init__(mgr)
        import http.server
        import json as _json
        import threading as _threading
        module = self

        class _H(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003
                pass

            def _json(self, obj):
                body = _json.dumps(obj, indent=2).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                m = module.get_osdmap()
                if self.path == "/api/health":
                    self._json(module.mgr.health_summary())
                elif self.path == "/api/osds":
                    self._json([{"id": o.id, "up": o.up, "in": o.in_,
                                 "addr": list(o.addr or ())}
                                for o in m.osds.values()])
                elif self.path == "/api/pools":
                    self._json([{"name": p.name, "id": p.id,
                                 "type": ("erasure" if p.is_erasure()
                                          else "replicated"),
                                 "size": p.size, "pg_num": p.pg_num}
                                for p in m.pools.values()])
                elif self.path == "/":
                    from html import escape as _esc
                    h = module.mgr.health_summary()
                    up = sum(1 for o in m.osds.values() if o.up)
                    rows = "".join(
                        f"<tr><td>{_esc(p.name)}</td><td>{p.size}</td>"
                        f"<td>{p.pg_num}</td></tr>"
                        for p in m.pools.values())
                    body = (
                        "<html><head><title>ceph-tpu</title></head>"
                        "<body><h1>ceph-tpu dashboard</h1>"
                        f"<p>health: "
                        f"<b>{_esc(str(h.get('status')))}</b></p>"
                        f"<p>epoch {m.epoch}; {up}/{len(m.osds)} "
                        "osds up</p>"
                        "<table border=1><tr><th>pool</th><th>size"
                        "</th><th>pg_num</th></tr>"
                        f"{rows}</table></body></html>").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

        import http.server as _hs
        self.httpd = _hs.ThreadingHTTPServer(("127.0.0.1", self.port),
                                             _H)
        self.addr = self.httpd.server_address
        _threading.Thread(target=self.httpd.serve_forever,
                          daemon=True,
                          name="mgr-dashboard").start()

    def tick(self) -> None:
        pass

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


class ProgressModule(MgrModule):
    """Completion fractions for long-running cluster motion (reference
    pybind/mgr/progress): recovery and backfill events derived from
    `pg stat` each tick, plus externally-noted events (rgw reshard).

    Event model: while a count (degraded PGs, misplaced objects) is
    nonzero, the event's BASELINE is the max count seen during the
    episode and progress = 1 - cur/baseline — monotone even when the
    count wobbles upward mid-recovery (the baseline rises with it).
    When the count returns to zero the event is pushed at 1.0, where
    the mon's linger window keeps it visible to pollers before it
    retires.  Events live in the LEADER's transient store (`progress
    update` mon command), so `ceph_cli progress` and the `status`
    one-liners answer without a mgr round-trip."""

    name = "progress"
    run_interval = 0.5

    # externally-noted events (class-level so sibling modules can note
    # without holding a ProgressModule reference)
    _ext_lock = threading.Lock()
    _external: dict[str, dict] = {}

    @classmethod
    def note_event(cls, eid: str, message: str,
                   progress: float) -> None:
        with cls._ext_lock:
            cls._external[eid] = {"message": message,
                                  "progress": progress}

    def __init__(self, mgr):
        super().__init__(mgr)
        self._baseline: dict[str, int] = {}     # episode max count
        self._started: dict[str, float] = {}    # episode start ts
        self.events: dict[str, float] = {}      # last pushed fraction

    def _push(self, eid: str, message: str, frac: float) -> None:
        cmd = {"prefix": "progress update", "id": eid,
               "message": message, "progress": frac}
        if eid in self._started:
            cmd["started_at"] = self._started[eid]
        r, _out = self.mon_command(cmd)
        if r == 0:
            self.events[eid] = frac

    def _track(self, eid: str, what: str, cur: int) -> None:
        import time as _time
        if cur <= 0:
            if eid in self._baseline:
                # episode over: publish the 1.0, then forget the
                # episode so the next one starts a fresh baseline
                self._push(eid, f"{what} (done)", 1.0)
                del self._baseline[eid]
                self._started.pop(eid, None)
                self.events.pop(eid, None)
            return
        base = max(self._baseline.get(eid, 0), cur)
        self._baseline[eid] = base
        self._started.setdefault(eid, _time.time())
        frac = 1.0 - cur / base if base else 0.0
        # monotone within the episode: a shrinking baseline ratio must
        # never walk a published fraction backwards
        frac = max(frac, self.events.get(eid, 0.0))
        self._push(eid, f"{what} ({cur} remaining)", min(frac, 0.999))

    def tick(self) -> None:
        r, out = self.mon_command({"prefix": "pg stat"})
        if r == 0:
            self._track("recovery", "Recovery: degraded PGs",
                        int(out.get("degraded_pgs", 0)))
            self._track("backfill", "Backfill: misplaced objects",
                        int(out.get("misplaced_objects", 0)))
        with self._ext_lock:
            ext = dict(self._external)
            self._external.clear()
        for eid, ev in ext.items():
            self._push(eid, ev["message"],
                       max(0.0, min(1.0, float(ev["progress"]))))


class RgwReshardModule(MgrModule):
    """Dynamic bucket-index resharding, run from the mgr (reference
    pybind/mgr's rgw support + RGWReshard's background processor).

    RGW stores register themselves at gateway construction (class
    registry — the in-process clusters this build runs host mgr and
    radosgw in one interpreter); each tick sweeps every attached
    store: resume reshards interrupted by a daemon kill, autoscale
    buckets whose per-shard entry count exceeds
    rgw_max_objs_per_shard.  Sweeps are cheap when nothing is over
    threshold (one dir_count per shard per bucket)."""

    name = "rgw_reshard"
    run_interval = 5.0

    _stores: list = []          # class-level: shared across daemons
    _reg_lock = threading.Lock()

    @classmethod
    def attach(cls, store) -> None:
        with cls._reg_lock:
            if store not in cls._stores:
                cls._stores.append(store)

    @classmethod
    def detach(cls, store) -> None:
        with cls._reg_lock:
            if store in cls._stores:
                cls._stores.remove(store)

    def tick(self) -> None:
        with self._reg_lock:
            stores = list(self._stores)
        msgs: list[str] = []
        for store in stores:
            try:
                stats = store.reshard_sweep()
            except Exception as e:  # noqa: BLE001 - degraded cluster
                msgs.append(f"reshard sweep failed: {e}")
                continue
            n = stats.get("resumed", 0) + stats.get("started", 0)
            if n:
                msgs.append(f"resharded {n} bucket(s)")
                # surface the reshard in `progress` too (one-shot,
                # already complete by the time the sweep returns)
                ProgressModule.note_event(
                    "rgw-reshard", f"Reshard: {n} bucket(s)", 1.0)
        self.mgr.set_health(self.name,
                            "HEALTH_WARN" if any(
                                "failed" in m for m in msgs)
                            else "HEALTH_OK", msgs)


DEFAULT_MODULES = [HealthModule, BalancerModule, PgAutoscalerModule,
                   TelemetryModule, DeviceHealthModule,
                   ProgressModule, RgwReshardModule]


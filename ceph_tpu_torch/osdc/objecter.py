"""Objecter: the client-side RADOS op state machine.

Re-expresses reference src/osdc/Objecter.{h,cc}: ops target a PG's
acting primary computed from the OSDMap via CRUSH *on the client*
(_calc_target, reference Objecter.cc:2759 -> OSDMap::pg_to_up_acting_osds),
are sent as MOSDOp and matched to MOSDOpReply by tid (op_submit :2256 /
_send_op :3216); every new map retargets and resends what's pending
(:1293).  Mon interaction (map subscription, admin commands) rides the
same engine, standing in for MonClient.
"""

from __future__ import annotations

import errno
import threading
import time

from ..common.tracked_op import OpTracker, TraceContext
from ..msg import Messenger
from ..msg import messages as M
from ..osd.osd_map import OSDMap, apply_inc_chain
from ..osd.types import hobject_t, spg_t


class TimedOut(Exception):
    pass


class Objecter:
    def __init__(self, mon_addr, name: str = "client", auth=None,
                 secure: bool = False, compress: str | None = None):
        self.auth = auth
        self.messenger = Messenger(name, auth=auth, secure=secure)
        self.messenger.compress_algo = compress
        self.messenger.add_dispatcher(self._dispatch)
        # op/command replies only wake waiter events — inline on the
        # reactor (reference ms_fast_dispatch).  Watch/notify events
        # run arbitrary user callbacks and stay on the executor.
        self.messenger.fast_dispatch = lambda msg: isinstance(
            msg, (M.MOSDOpReply, M.MMonCommandAck))
        # one (host, port) or a monmap-style list of them (reference
        # MonClient hunts across the monmap)
        from ..msg.addrs import normalize_mon_addrs
        self.mon_addrs = normalize_mon_addrs(mon_addr)
        self._mon_idx = 0
        self.mon_addr = self.mon_addrs[0]
        self.mon_conn = self.messenger.connect(self.mon_addrs[0])
        self.osdmap = OSDMap()
        self.map_event = threading.Event()
        self._map_nudge_pending = False
        self._tid = 0
        self._lock = threading.Lock()
        # client-side op tracking: every op gets the ROOT trace span
        # here (Dapper-style; the OSD continues the same span, shard
        # sub-ops branch children) — `dump_historic_ops` on this
        # tracker shows client-observed latency per op
        self.op_tracker = OpTracker(complaint_time=30.0)
        self._waiters: dict[int, dict] = {}
        self._mon_waiters: dict[int, dict] = {}
        self._auth_waiters: dict[int, dict] = {}
        # linger ops: cookie -> callback(oid_name, payload)
        # (reference linger_ops / watch support, Objecter.h)
        self._watch_cbs: dict[int, object] = {}
        self._next_cookie = 0
        # linger registrations: cookie -> {"pool", "name"} — the linger
        # thread re-asserts each on the current primary so a watch
        # survives its OSD's death/remap (reference Objecter.cc:1293
        # _scan_requests resending linger ops on every new map; here a
        # periodic check-and-rewatch replaces map-push-driven resend)
        self._lingers: dict[int, dict] = {}
        self.linger_interval = 5.0
        self._linger_stop = threading.Event()
        self._linger_thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        while self.osdmap.epoch == 0 and time.time() < deadline:
            self.mon_conn.send_message(M.MMonGetMap())
            if not self.map_event.wait(1.0):
                self._rotate_mon()
            self.map_event.clear()
        if self.osdmap.epoch == 0:
            raise TimedOut("no osdmap from mon")
        # cephx: trade our client key for a service ticket so OSD
        # connections can be authorized (reference MonClient
        # authenticate + CephxTicketManager)
        if self.auth is not None and self.auth.key is not None and \
                self.auth.ticket_blob is None:
            self._fetch_ticket()

    def _fetch_ticket(self, timeout: float = 5.0) -> None:
        import base64
        from ..auth import cephx
        with self._lock:
            self._tid += 1
            tid = self._tid
            w = {"event": threading.Event(), "reply": None}
            self._auth_waiters[tid] = w
        self.mon_conn.send_message(M.MAuth(self.auth.entity, tid))
        if not w["event"].wait(timeout):
            raise TimedOut("no auth reply from mon")
        reply = w["reply"]
        if reply.result != 0:
            raise PermissionError(
                f"mon refused ticket: errno {-reply.result}")
        sealed = cephx.unseal(self.auth.key, reply.sealed_key)
        self.auth.set_ticket(
            reply.ticket, base64.b64decode(sealed["session_key"]),
            float(sealed.get("expires", 0.0)))

    def _rotate_mon(self) -> None:
        """Hunt to the next monitor (reference MonClient::_reopen_session
        rotation when the current mon stops answering)."""
        if len(self.mon_addrs) == 1:
            return
        self._mon_idx = (self._mon_idx + 1) % len(self.mon_addrs)
        self.mon_addr = self.mon_addrs[self._mon_idx]
        self.mon_conn = self.messenger.connect(self.mon_addr)

    def shutdown(self) -> None:
        self._linger_stop.set()
        self.messenger.shutdown()

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, M.MMonMap):
            newmap = OSDMap.from_json(msg.map_json)
            # multiple mons publish to us after rotation; a slower
            # mon's older epoch must not regress the map
            if newmap.epoch >= self.osdmap.epoch:
                self.osdmap = newmap
            self._map_nudge_pending = False
            self.map_event.set()
        elif isinstance(msg, M.MOSDMapInc):
            # incremental publish / keepalive ack: apply the delta
            # chain like the OSD does; a gap (or a keepalive claiming
            # an epoch we never got) re-requests a full map
            m = apply_inc_chain(self.osdmap, msg.incs)
            if m is None or (not msg.incs and
                             msg.epoch > self.osdmap.epoch):
                try:
                    self.mon_conn.send_message(M.MMonGetMap())
                except Exception:  # noqa: BLE001 - mon electing
                    pass
                return
            self.osdmap = m
            self._map_nudge_pending = False
            self.map_event.set()
        elif isinstance(msg, M.MOSDOpReply):
            with self._lock:
                w = self._waiters.pop(msg.tid, None)
            if w is not None:
                w["reply"] = msg
                w["event"].set()
        elif isinstance(msg, M.MMonCommandAck):
            with self._lock:
                w = self._mon_waiters.pop(msg.tid, None)
            if w is not None:
                w["reply"] = msg
                w["event"].set()
        elif isinstance(msg, M.MAuthReply):
            with self._lock:
                w = self._auth_waiters.pop(msg.tid, None)
            if w is not None:
                w["reply"] = msg
                w["event"].set()
        elif isinstance(msg, M.MWatchNotify) and not msg.is_ack:
            cb = self._watch_cbs.get(msg.cookie)
            if cb is not None:
                try:
                    cb(msg.oid.name, msg.payload)
                finally:
                    conn.send_message(M.MWatchNotify(
                        msg.oid, msg.notify_id, msg.cookie, b"",
                        is_ack=True))

    # -- map plumbing -------------------------------------------------------

    def refresh_map(self, timeout: float = 5.0) -> None:
        # carry our epoch: a current map earns a keepalive ack, a
        # stale one an incremental chain — not a full payload per
        # refresh (docs/ARCHITECTURE.md "Map distribution")
        self.map_event.clear()
        self.mon_conn.send_message(
            M.MMonGetMap(have_epoch=self.osdmap.epoch))
        if not self.map_event.wait(timeout):
            self._rotate_mon()
            self.mon_conn.send_message(
                M.MMonGetMap(have_epoch=self.osdmap.epoch))
            self.map_event.wait(timeout)

    def _calc_target(self, pool_id: int, name: str
                     ) -> tuple[spg_t, int] | None:
        """reference _calc_target: object -> pg -> acting primary."""
        pgid = self.osdmap.object_to_pg(pool_id, name)
        spg = self.osdmap.primary_shard(pgid)
        if spg is None:
            return None
        _, _, _, primary = self.osdmap.pg_to_up_acting_osds(pgid)
        return spg, primary

    # -- op submission ------------------------------------------------------

    def op_submit(self, pool_id: int, name: str, ops: list,
                  data: bytes = b"", timeout: float = 30.0,
                  attempts: int = 3, snap: int = 0,
                  snapc: list | None = None,
                  qos_class: str | None = None) -> M.MOSDOpReply:
        # an expired ticket would make every OSD reconnect fail
        # permanently; refresh before it lapses (reference
        # CephxTicketManager renewal)
        if self.auth is not None and self.auth.key is not None and \
                not self.auth.ticket_valid():
            try:
                self._fetch_ticket()
            except Exception:  # noqa: BLE001 - mon may be electing
                pass
        oid = hobject_t(pool=pool_id, name=name, snap=snap)
        # root trace span: origin_ts stamps "objecter submit" on every
        # downstream timeline of this request
        trace = TraceContext.new()
        top = self.op_tracker.create(
            "osd_op", f"{pool_id}/{name} {[op[0] for op in ops]}",
            trace)
        try:
            return self._op_submit_attempts(
                pool_id, name, ops, data, timeout, attempts, snapc,
                oid, trace, top, qos_class)
        finally:
            # idempotent (reply/timeout paths unregister with their
            # result); catches exceptions escaping the retry loop —
            # e.g. connect() to a dead primary — that would otherwise
            # leak the op in the tracker forever
            self.op_tracker.unregister(top, -errno.EIO)

    def _op_submit_attempts(self, pool_id, name, ops, data, timeout,
                            attempts, snapc, oid, trace, top,
                            qos_class=None) -> M.MOSDOpReply:
        last_err = None
        # EAGAIN (not-primary / peering-incomplete) replies arrive in
        # milliseconds now that the OSD fences every op path; they ride
        # a short backoff BUDGET instead of the attempt counter, or a
        # 2s peering blip would burn all attempts instantly (reference:
        # client op backoff, RECOVERY_WAIT).  Anchored at the FIRST
        # EAGAIN (not op entry — a slow first attempt must not eat the
        # budget) and bounded well below the op timeout: a PG that
        # CANNOT peer (too many shards down) must fail fast, not pin
        # the caller for the whole op budget
        deadline = None
        attempt = 0
        while attempt < attempts:
            tgt = self._calc_target(pool_id, name)
            if tgt is None:
                self.refresh_map()
                last_err = -errno.EHOSTUNREACH
                attempt += 1
                continue
            spg, primary = tgt
            info = self.osdmap.osds.get(primary)
            if info is None or info.addr is None:
                self.refresh_map()
                last_err = -errno.EHOSTUNREACH
                attempt += 1
                continue
            with self._lock:
                self._tid += 1
                tid = self._tid
                w = {"event": threading.Event(), "reply": None}
                self._waiters[tid] = w
            conn = self.messenger.connect(tuple(info.addr))
            conn.send_message(M.MOSDOp(spg, oid, ops, data, tid,
                                       self.osdmap.epoch, snapc=snapc,
                                       trace=trace.to_wire(),
                                       qos=qos_class))
            if w["event"].wait(timeout):
                reply = w["reply"]
                if reply.epoch > self.osdmap.epoch and \
                        not self._map_nudge_pending:
                    # the OSD is on a newer map (e.g. a pool's pg_num
                    # grew and our target PG split): nudge a refresh so
                    # subsequent ops retarget to the children without
                    # having to eat an EAGAIN first.  One nudge per
                    # staleness window — a burst of stale replies must
                    # not multiply into a burst of mon requests.
                    self._map_nudge_pending = True
                    try:
                        self.mon_conn.send_message(M.MMonGetMap(
                            have_epoch=self.osdmap.epoch))
                    except Exception:  # noqa: BLE001 - mon electing
                        pass
                if reply.result == -errno.EAGAIN:
                    # primary moved or PG still peering: retarget
                    top.mark_event("retry")
                    self.refresh_map()
                    last_err = reply.result
                    if deadline is None:
                        deadline = time.time() + min(timeout, 5.0)
                    if time.time() >= deadline:
                        attempt += 1    # budget exhausted — the
                        # retarget fast-path below must not bypass it
                        # (sustained map churn would spin forever)
                    elif self._calc_target(pool_id, name) != tgt:
                        # the refreshed map moved the op — a pg_num
                        # change (split/merge) or primary remap, not a
                        # peering blip: go straight at the new target
                        # instead of eating the flat backoff
                        pass
                    else:
                        time.sleep(0.25)
                    continue
                top.mark_event("reply")
                self.op_tracker.unregister(top, reply.result)
                return reply
            with self._lock:
                self._waiters.pop(tid, None)
            top.mark_event("attempt_timeout")
            self.refresh_map()
            last_err = -errno.ETIMEDOUT
            attempt += 1
        top.mark_event("timeout")
        self.op_tracker.unregister(top, last_err)
        raise TimedOut(f"op {name} failed after {attempts} attempts "
                       f"(last {last_err})")

    # -- watch/notify -------------------------------------------------------

    def watch(self, pool_id: int, name: str, callback) -> int:
        """Register a watch; returns the cookie (reference
        IoCtxImpl::watch via linger ops)."""
        # globally unique cookie: per-client counters collide across
        # processes (two fresh clients would both register cookie 1 on
        # one object, clobbering each other's watch — fatal for
        # watcher-liveness protocols like the RBD exclusive lock)
        import os as _os
        with self._lock:
            cookie = int.from_bytes(_os.urandom(8), "little") | 1
            while cookie in self._watch_cbs:
                cookie = int.from_bytes(_os.urandom(8), "little") | 1
            self._watch_cbs[cookie] = callback
        self.op_submit(pool_id, name, [["watch", cookie]])
        with self._lock:
            self._lingers[cookie] = {"pool": pool_id, "name": name}
        self._ensure_linger_thread()
        return cookie

    def unwatch(self, pool_id: int, name: str, cookie: int) -> None:
        # pop BEFORE the op: a linger tick that starts after this point
        # sees the cookie gone and skips; a tick already mid-flight is
        # compensated by its own post-rewatch membership re-check (see
        # _linger_loop) — so no lock is held across a blocking op
        with self._lock:
            self._lingers.pop(cookie, None)
        self.op_submit(pool_id, name, [["unwatch", cookie]])
        self._watch_cbs.pop(cookie, None)

    def _ensure_linger_thread(self) -> None:
        with self._lock:
            if self._linger_thread is not None and \
                    self._linger_thread.is_alive():
                return
            self._linger_thread = threading.Thread(
                target=self._linger_loop, daemon=True,
                name="objecter-linger")
            self._linger_thread.start()

    def _linger_loop(self) -> None:
        """Keep every registered watch alive across OSD death, revive,
        and PG remap.  Each tick: refresh the map, then verify (via
        listwatchers, a cheap read on the primary) that our cookie is
        still registered — a fresh primary or a restarted OSD has an
        empty watcher table — and re-send the watch op if not.  The
        reference drives this from map pushes + per-watch ping timers
        (Objecter::_linger_ops_resend, WatchNotify ping); a periodic
        check-and-rewatch gives the same guarantee without a mon-push
        subscription."""
        import json as _json
        while not self._linger_stop.wait(self.linger_interval):
            with self._lock:
                regs = dict(self._lingers)
            if not regs:
                continue
            try:
                self.refresh_map(timeout=2.0)
            except Exception:  # noqa: BLE001 - mon electing: next tick
                pass
            for cookie, reg in regs.items():
                with self._lock:
                    if cookie not in self._lingers:
                        continue         # unwatched meanwhile
                try:
                    reply = self.op_submit(
                        reg["pool"], reg["name"], [["listwatchers"]],
                        timeout=5.0, attempts=1)
                    live = _json.loads(bytes(reply.data).decode()) \
                        if reply.result == 0 else []
                    if cookie not in live:
                        self.op_submit(
                            reg["pool"], reg["name"],
                            [["watch", cookie]], timeout=5.0,
                            attempts=1)
                        # compensate the unwatch race: if the app
                        # unwatched while we were re-asserting, undo —
                        # otherwise the orphan cookie would eat every
                        # future notify's ack wait
                        with self._lock:
                            still = cookie in self._lingers
                        if not still:
                            self.op_submit(
                                reg["pool"], reg["name"],
                                [["unwatch", cookie]], timeout=5.0,
                                attempts=1)
                except Exception:  # noqa: BLE001 - OSD still down:
                    continue           # re-check next tick

    def notify(self, pool_id: int, name: str, payload: bytes) -> None:
        self.op_submit(pool_id, name, [["notify", len(payload)]],
                       bytes(payload))

    # -- mon commands -------------------------------------------------------

    def mon_command(self, cmd: dict, timeout: float = 15.0
                    ) -> tuple[int, dict]:
        """Admin command with mon failover: a dead or quorum-less mon
        rotates the session to the next one (reference MonClient
        hunting + command resend on session reset)."""
        deadline = time.time() + timeout
        # the attempt window scales with the caller's budget: a SLOW
        # (not dead) mon whose ack RT exceeds a fixed 3 s window would
        # never land an ack — every resend starts a new tid, and the
        # resend storm itself adds mon load.  Short budgets keep the
        # snappy 3 s hunt; long budgets wait the mon out.
        attempt_timeout = min(max(3.0, timeout / 3.0), timeout)
        while True:
            with self._lock:
                self._tid += 1
                tid = self._tid
                w = {"event": threading.Event(), "reply": None}
                self._mon_waiters[tid] = w
            self.mon_conn.send_message(M.MMonCommand(cmd, tid))
            if w["event"].wait(attempt_timeout):
                ack = w["reply"]
                if ack.result == -errno.EAGAIN and \
                        time.time() < deadline:
                    # electing / quorum-less mon: another mon may have a
                    # working leader — rotate before retrying
                    self._rotate_mon()
                    time.sleep(0.3)
                    continue
                return ack.result, ack.out
            with self._lock:
                self._mon_waiters.pop(tid, None)
            if time.time() >= deadline:
                raise TimedOut(f"mon command {cmd.get('prefix')}")
            self._rotate_mon()

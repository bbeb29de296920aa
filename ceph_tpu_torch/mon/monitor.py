"""Monitor: the replicated cluster control plane.

Re-expresses the slice of reference src/mon/ the storage path needs —
the OSDMonitor role (src/mon/OSDMonitor.cc): author of the OSDMap,
consumer of boot/failure reports with a quorum-of-reporters rule
(prepare_failure, reference OSDMonitor.cc:3226 / can_mark_down :3019),
EC profile management with plugin validation (normalize_profile :7190 +
stripe_unit validation :7211-7229), pool creation, and map distribution
to every subscriber on each epoch.

Replication: 2f+1 monitors run rank-based election + Paxos
(mon/paxos.py — reference src/mon/ElectionLogic.cc, src/mon/Paxos.cc).
Every map mutation is a paxos value; it takes effect (and is published
to subscribers) only on commit, on every mon in the quorum.  Peons
forward mutating traffic to the leader (reference Monitor::forward_
request_leader, Monitor.cc:4583) and serve reads from committed state
under the leader's lease.  A single-mon deployment runs the same code
with a quorum of one.

PaxosService family (reference src/mon/PaxosService.h: OSDMonitor,
AuthMonitor, ConfigMonitor, MDSMonitor, MgrMonitor): the replicated
value carries EVERY service's state — osdmap, auth entities, cluster
config, fsmap, mgrmap — under one global version, so keyring changes
and MDS/mgr registration ride the same commit path as map mutations.
Durability: every committed value (plus the paxos promise/uncommitted
protocol state) persists through MonitorStore (mon/store.py, the
MonitorDBStore role) — a restarted mon, or a whole restarted quorum,
comes back with full state.
"""

from __future__ import annotations

import copy
import errno
import threading
import time

import json

from ..auth.keyring import Keyring
from ..common.perf_counters import (CONTROL_LAT_BUCKETS,
                                    PerfCountersBuilder)
from ..ec import ErasureCodeError, ErasureCodePluginRegistry, Profile
from ..msg import Messenger
from ..msg import messages as M
from ..osd.osd_map import Incremental, OSDMap
from ..osd.types import PoolType, pg_t
from .paxos import ElectionLogic, Paxos
from .store import MonitorStore

# the card's plugin is "torch" where ceph_tpu names "jax"
DEFAULT_EC_PROFILE = {"plugin": "torch", "k": "2", "m": "1",
                      "technique": "cauchy",
                      "crush-failure-domain": "host"}

# NOTE: no "auth *" here — auth surfaces return entity keys, which a
# read-only ("allow r") credential must never see (reference MonCap
# treats auth read as a privileged grant)
READONLY_COMMANDS = {
    "osd erasure-code-profile get", "osd erasure-code-profile ls",
    "osd pool ls", "osd pool get", "status", "osd tree", "mon stat",
    "config get", "config dump", "health", "pg stat",
    "osd mclock profile get",
    "osd ok-to-stop", "osd safe-to-destroy",
    "fs ls", "fs dump", "mgr dump", "progress",
}

# read-only for caps purposes but answerable only by the leader: the
# payload is leader-local transient state (slow_op_reports and
# pg_stat_reports are not paxos-committed), so a peon serving them
# locally would report HEALTH_OK / safe while the cluster has blocked
# ops or degraded data
LEADER_ONLY_READS = {"health", "pg stat", "progress",
                     "osd ok-to-stop", "osd safe-to-destroy"}

# finished progress events linger this long in `progress` output so a
# poll-cadence observer still sees the 1.0 before the row retires
# (reference mgr progress module's persist window, much shortened)
PROGRESS_LINGER = 60.0

# how long an OSD's MPGStats report stays authoritative; the OSD
# re-sends every osd_pg_stat_interval (default 0.5s), so 10s of
# silence means the daemon is gone, not healthy
PG_STAT_FRESH = 10.0

FWD_TID_BASE = 1 << 40


class Monitor:
    # committed epoch deltas kept for incremental publishes: a
    # subscriber whose epoch fell further behind than this gets a full
    # map (reference mon_max_osdmap_epochs bounding send_incremental)
    OSDMAP_INC_RING = 512
    # burst-coalescing window for fire-and-forget maintenance
    # mutations (boots, failure mark-downs): everything that lands
    # within one window commits as ONE map epoch — a 64-OSD cold start
    # is a handful of epochs instead of 64 (docs/ARCHITECTURE.md "Map
    # distribution").  Well under every liveness timeout that waits on
    # the resulting map (boot wait 10 s, heartbeat grace 4 s).
    MAP_BATCH_WINDOW = 0.05

    def __init__(self, addr: tuple[str, int] = ("127.0.0.1", 0),
                 failure_quorum: int = 2, auth=None, secure: bool = False,
                 data_dir: str | None = None,
                 asok_path: str | None = None,
                 device: str = "cuda"):
        # where a `torch` profile that names no device is validated: the
        # codec is built there, so a CUDA request without a GPU returns
        # its error to the command
        self.device = str(device)
        self.store = MonitorStore(data_dir)
        self.osdmap = OSDMap()
        self.osdmap.ec_profiles["default"] = dict(DEFAULT_EC_PROFILE)
        self.lock = threading.RLock()
        self.failure_quorum = failure_quorum
        self._failure_reports: dict[int, set[int]] = {}
        # per-OSD slow-op reports (MOSDSlowOpReport) feeding the
        # `health` SLOW_OPS check.  Transient leader-side state, not
        # paxos-committed: OSDs re-report while the condition holds
        # and the check expires when reports stop (see _cmd_health).
        self.slow_op_reports: dict[int, dict] = {}
        # per-OSD PG-state reports (MPGStats): degraded/misplaced/
        # unfound counts + pending split/merge push targets.  Feeds
        # `pg stat`, the PG_DEGRADED health check, the pg_num-decrease
        # interleave guard, and `osd safe-to-destroy`.  Same transient
        # leader-side lifecycle as slow_op_reports.
        self.pg_stat_reports: dict[int, dict] = {}
        # mgr-pushed progress events (`progress update` -> `progress`
        # / `status` one-liners): recovery/backfill/reshard completion
        # fractions, reference mgr progress module.  Same transient
        # leader-side lifecycle as slow_op_reports — the mgr re-derives
        # and re-pushes from `pg stat` every tick.
        self.progress_events: dict[str, dict] = {}
        # OSDs being drained (osd drain): weight walks down by `step`
        # per maintenance tick until 0, each step a committed epoch so
        # CRUSH gradually backfills the OSD out instead of one storm.
        # Leader-local: a failover pauses an unfinished walk until the
        # operator re-issues `osd drain` (documented).
        self._draining: dict[int, float] = {}
        # map subscribers: conn -> the osdmap epoch we believe it has
        # (reference OSDMonitor's osd_epochs / session subscriptions).
        # Updated optimistically on every send and authoritatively by
        # each MMonGetMap's have_epoch — so a publish ships only the
        # delta since the last send, and a current daemon's heartbeat
        # keepalive ships ~nothing.
        self._subscribers: dict[object, int] = {}
        # ring of committed epoch deltas: epoch -> Incremental wire
        # JSON (with its `prev` link; a paxos catch-up commit may span
        # several epochs in one delta)
        self._inc_ring: dict[int, dict] = {}
        # (epoch, bytes) of the last serialized full payload — so
        # keepalive accounting doesn't re-serialize the map it exists
        # to avoid serializing
        self._full_size_cache: tuple[int, int] = (-1, 0)
        # maintenance-mutation batching (MAP_BATCH_WINDOW)
        self._batch_dirty = False
        self._batch_timer: threading.Timer | None = None
        # map-distribution observability (`osdmap status` asok + the
        # cluster_bench --scale gates)
        self.perf = (
            PerfCountersBuilder("mon")
            .add_u64_counter("map_epochs", "osdmap epochs committed")
            .add_u64_counter("map_full_sends", "full-map payloads sent")
            .add_u64_counter("map_inc_sends",
                             "incremental chains sent")
            .add_u64_counter("map_keepalive_sends",
                             "empty keepalive acks sent (subscriber "
                             "already current)")
            .add_u64_counter("map_full_bytes",
                             "payload bytes of full-map sends")
            .add_u64_counter("map_inc_bytes",
                             "payload bytes of incremental sends")
            .add_u64_counter("map_full_equiv_bytes",
                             "bytes the same sends would have cost "
                             "under full-map publish (the baseline "
                             "the --scale bench gates against)")
            .add_u64_counter("map_batched_mutations",
                             "maintenance mutations coalesced through "
                             "the batch window")
            .add_time_avg("map_commit",
                          "wall-clock per paxos value commit")
            # command-dispatch observability (ROADMAP item 4 names the
            # single-threaded dispatch loop as a fan-out suspect): depth
            # is sampled at entry, latency lands in lat_mon_dispatch
            # plus a per-prefix lat_mon_dispatch_<cmd> histogram
            # (hinc-created on first use, default axis)
            .add_u64_counter("mon_commands", "commands dispatched")
            .add_gauge("mon_dispatch_depth",
                       "commands currently inside handle_command")
            .add_histogram("lat_mon_dispatch",
                           "per-command dispatch wall-clock",
                           buckets=CONTROL_LAT_BUCKETS)
            .create_perf_counters())
        self.auth = auth       # auth.CephxAuth with keyring (AuthMonitor)
        # PaxosService state beyond the OSDMap (reference AuthMonitor /
        # ConfigMonitor / MDSMonitor / MgrMonitor)
        self.keyring = auth.keyring if auth is not None and \
            auth.keyring is not None else Keyring()
        self.config_db: dict[str, dict[str, str]] = {}
        self.fsmap: dict = {"epoch": 0, "filesystems": {}}
        self.mgrmap: dict = {"epoch": 0, "active": None, "standbys": []}
        self.paxos_version = 0
        committed = self.store.load_committed()
        if committed is not None:
            self._adopt_value(committed)          # restart: reload state
        self.messenger = Messenger("mon", auth=auth, secure=secure)
        self.messenger.add_dispatcher(self._dispatch)
        self.addr = self.messenger.bind(addr)
        # quorum state (filled by join(); defaults to standalone)
        self.rank = 0
        self.mon_addrs: list[tuple[str, int]] = [self.addr]
        self._committed_json = self._current_value()
        self._fwd_tid = FWD_TID_BASE
        self._fwd_waiters: dict[int, tuple] = {}
        self._stop = threading.Event()
        self._maint: threading.Thread | None = None
        self.election: ElectionLogic | None = None
        self.paxos: Paxos | None = None
        self.join([self.addr], 0, start_election=False)
        self.paxos.role = "leader"
        self.paxos.leader = 0
        self.paxos.quorum = [0]
        # out-of-band introspection (reference `ceph daemon mon.X ...`)
        self.asok = None
        if asok_path:
            from ..common.admin_socket import AdminSocket
            self.asok = AdminSocket(asok_path)
            for prefix in ("osdmap status", "osdmap_status"):
                self.asok.register_command(
                    prefix, lambda cmd: self.map_stats())
            self.asok.register_command(
                "perf dump",
                lambda cmd: {self.perf.name: self.perf.dump()})
            self.asok.register_command(
                "mon_status", lambda cmd: self.quorum_status())
            # wire-plane flight recorder (docs/TRACING.md "Wire
            # plane"); both spellings like the OSD asoks
            for prefix in ("messenger status", "messenger_status"):
                self.asok.register_command(
                    prefix, lambda cmd: dict(
                        self.messenger.ledger.status(),
                        daemon=self.messenger.stats.totals()))
            for prefix in ("conn profile", "conn_profile"):
                self.asok.register_command(
                    prefix, lambda cmd: self.messenger.ledger
                    .conn_profile(
                        last=int(cmd["last"]) if "last" in cmd
                        else None))

    # -- the replicated multi-service value ---------------------------------

    def _current_value(self) -> dict:
        """Snapshot of every PaxosService's state under the global
        version ("epoch" is the paxos version the protocol orders by;
        the OSDMap keeps its own epoch inside)."""
        return {
            "epoch": self.paxos_version,
            "osdmap": self.osdmap.to_json(),
            "auth": self.keyring.to_json(),
            "config": {s: dict(d) for s, d in self.config_db.items()},
            "fsmap": copy.deepcopy(self.fsmap),
            "mgrmap": copy.deepcopy(self.mgrmap),
        }

    def _adopt_value(self, value: dict, force: bool = False) -> None:
        """Adopt a committed multi-service value into live state.

        force=True (quorum-loss rollback) restores the committed map
        UNCONDITIONALLY: the local osdmap may carry an uncommitted
        mutation with a bumped epoch, which is exactly the state the
        rollback must discard — the normal newer-epoch guard would
        keep it."""
        with self.lock:
            if force:
                self.paxos_version = value.get("epoch", 0)
            else:
                self.paxos_version = max(self.paxos_version,
                                         value.get("epoch", 0))
            om = value.get("osdmap")
            if om is not None and (
                    force or om.get("epoch", 0) >= self.osdmap.epoch):
                self.osdmap = OSDMap.from_json(om)
            if value.get("auth") is not None:
                self.keyring.replace_from_json(value["auth"])
            self.config_db = {s: dict(d) for s, d in
                              value.get("config", {}).items()}
            self.fsmap = copy.deepcopy(value.get(
                "fsmap", {"epoch": 0, "filesystems": {}}))
            self.mgrmap = copy.deepcopy(value.get(
                "mgrmap", {"epoch": 0, "active": None, "standbys": []}))

    # -- quorum wiring -------------------------------------------------------

    def join(self, mon_addrs: list[tuple[str, int]], rank: int,
             start_election: bool = True) -> None:
        """Join a monitor cluster: ranks index mon_addrs (the monmap,
        reference MonMap)."""
        self.rank = rank
        self.mon_addrs = [tuple(a) for a in mon_addrs]
        n = len(self.mon_addrs)
        self.election = ElectionLogic(
            rank, n, self._send_paxos, self._on_win, self._on_defeat)
        self.paxos = Paxos(rank, n, self._send_paxos, self._apply_commit,
                           lambda: self._committed_json,
                           self._on_quorum_loss, store=self.store)
        if self._maint is None:
            self._maint = threading.Thread(
                target=self._maintenance_loop, daemon=True,
                name=f"mon.{rank}.maint")
            self._maint.start()
        if start_election and n > 1:
            threading.Thread(target=self.election.start,
                             daemon=True).start()

    def _send_paxos(self, peer: int, **fields) -> None:
        try:
            conn = self.messenger.connect(self.mon_addrs[peer])
            conn.send_message(M.MMonPaxos(rank=self.rank, **fields))
        except Exception:  # noqa: BLE001 - dead peer
            pass

    def _on_win(self, epoch: int, quorum: list[int]) -> None:
        self.paxos.win(epoch, quorum)

    def _on_defeat(self, leader: int, epoch: int,
                   quorum: list[int]) -> None:
        self.paxos.defeat(leader, epoch, quorum)

    def _on_quorum_loss(self) -> None:
        # restore the last committed state (an uncommitted local
        # mutation must not leak) and go back to the polls
        with self.lock:
            self._batch_dirty = False   # batched mutations roll back too
            self._adopt_value(self._committed_json, force=True)
        if len(self.mon_addrs) > 1:
            self.election.start()

    def _apply_commit(self, value: dict) -> None:
        """A paxos value committed: persist, adopt, publish (every
        quorum mon).  The store write comes FIRST — a committed value
        the cluster acted on must survive this mon's restart
        (MonitorDBStore contract).  The committed-to-committed osdmap
        delta lands in the incremental ring here, so EVERY quorum mon
        (not just the leader) can serve delta chains; a restarted mon
        starts with an empty ring and serves fulls until it refills."""
        self.store.save_committed(value)
        with self.lock:
            old_om = self._committed_json.get("osdmap")
            new_om = value.get("osdmap")
            if old_om and new_om and \
                    new_om.get("epoch", 0) > old_om.get("epoch", 0):
                inc = Incremental.diff(old_om, new_om)
                self._inc_ring[inc.epoch] = inc.to_json()
                while len(self._inc_ring) > self.OSDMAP_INC_RING:
                    del self._inc_ring[min(self._inc_ring)]
                self.perf.inc("map_epochs",
                              new_om["epoch"] - old_om["epoch"])
            self._adopt_value(value)
            self._committed_json = value
        self._publish()

    def _maintenance_loop(self) -> None:
        """Leader: lease grants.  Peon: lease expiry -> election.
        Candidate: election retry (reference Monitor::tick)."""
        while not self._stop.wait(Paxos.LEASE_INTERVAL / 2):
            try:
                self._reap_fwd_waiters()
                if self.paxos.role == "leader":
                    if not self.paxos.quorum_alive():
                        # partitioned into a minority: stop serving
                        with self.paxos.lock:
                            self.paxos.role = "electing"
                        self._on_quorum_loss()
                    else:
                        self.paxos.grant_lease()
                        self._drain_tick()
                elif not self.election.electing and \
                        not self.election.recently_deferred() and \
                        len(self.mon_addrs) > 1 and \
                        (self.paxos.lease_expired() or
                         self.paxos.role == "electing"):
                    # lease gone (leader dead) or never settled: go to
                    # the polls — but never while a round we proposed or
                    # deferred to is still in flight (livelock)
                    self.election.start()
                self.election.tick()
            except Exception:  # noqa: BLE001
                pass

    @property
    def is_leader(self) -> bool:
        return self.paxos.role == "leader"

    def _lease_ok(self) -> bool:
        """May this mon serve reads from committed state?"""
        return self.is_leader or (self.paxos.role == "peon" and
                                  not self.paxos.lease_expired())

    def quorum_status(self) -> dict:
        return {"rank": self.rank, "role": self.paxos.role,
                "leader": self.paxos.leader,
                "quorum": list(self.paxos.quorum),
                "election_epoch": self.election.epoch}

    def _reap_fwd_waiters(self, max_age: float = 30.0) -> None:
        """Drop forwarded-command waiters whose leader died before
        acking (the client has long since timed out and retried)."""
        cutoff = time.time() - max_age
        with self.lock:
            for ftid in [t for t, e in self._fwd_waiters.items()
                         if e[2] < cutoff]:
                del self._fwd_waiters[ftid]

    def shutdown(self) -> None:
        self._stop.set()
        with self.lock:
            if self._batch_timer is not None:
                self._batch_timer.cancel()
                self._batch_timer = None
        with self.paxos.lock:
            self.paxos.role = "down"   # wait_for_leader must skip us
        if self.asok is not None:
            self.asok.shutdown()
        self.messenger.shutdown()
        self.store.close()

    # -- commit / publish ----------------------------------------------------

    def _propose_current(self) -> bool:
        """Leader-only: replicate the locally-mutated state.  On failure
        the mutation is rolled back (quorum-loss path)."""
        with self.lock:
            self.paxos_version += 1
            if self._batch_dirty:
                # pending batched osdmap mutations ride this value —
                # and they MUST carry an epoch bump: map content never
                # changes under an unchanged epoch (the incremental/
                # keepalive machinery keys entirely off it), and
                # non-osdmap command paths (config/auth/fs/mgr) reach
                # here without bumping.  An osdmap command path that
                # already bumped just spends one extra epoch number.
                self.osdmap.bump_epoch()
                self._batch_dirty = False
            value = self._current_value()
        with self.perf.time("map_commit"):
            ok = self.paxos.propose(value)
        return ok

    def _commit_batched(self) -> None:
        """Batched commit for fire-and-forget maintenance mutations
        (boots, failure mark-downs): the mutation is already applied
        to the local map; everything arriving within MAP_BATCH_WINDOW
        commits as ONE epoch + ONE publish instead of one each — the
        difference between O(burst) and O(1) epochs when 64 OSDs boot
        or a host's worth of OSDs is reported down at once."""
        with self.lock:
            self._batch_dirty = True
            self.perf.inc("map_batched_mutations")
            if self._batch_timer is None:
                t = threading.Timer(self.MAP_BATCH_WINDOW,
                                    self._flush_batch)
                t.daemon = True
                self._batch_timer = t
                t.start()

    def _flush_batch(self) -> None:
        # the propose stays INSIDE self.lock like every synchronous
        # command path: proposing with only the paxos proposal_lock
        # held would reverse the mon.lock -> proposal_lock order those
        # paths establish (lockdep-caught deadlock with _apply_commit
        # re-acquiring mon.lock on the commit callback)
        with self.lock:
            self._batch_timer = None
            if not self._batch_dirty or not self.is_leader:
                # an interleaved synchronous command already committed
                # the batch (or leadership moved: reporters re-send)
                self._batch_dirty = False
                return
            # _propose_current bumps the epoch for the dirty batch
            self._propose_current()

    def _map_payload(self) -> dict:
        """The MMonMap body: the committed osdmap plus the central
        config sections (reference ConfigMonitor: config rides map
        publishes so daemons apply `config set` / `osd mclock profile
        set` at runtime; OSDMap.from_json ignores the extra key)."""
        j = dict(self._committed_json.get("osdmap", {}))
        j["config"] = self._committed_json.get("config", {})
        return j

    def _publish(self) -> None:
        """Push the committed map to every subscriber (reference OSDMap
        epoch share; subscribers are daemons and clients) — as the
        delta since each subscriber's tracked epoch, a full map only
        when its epoch fell off the incremental ring (or it never had
        one)."""
        with self.lock:
            subs = list(self._subscribers.items())
        for conn, have in subs:
            try:
                self._send_map_update(conn, have)
            except Exception:  # noqa: BLE001
                with self.lock:
                    self._subscribers.pop(conn, None)

    def _committed_epoch(self) -> int:
        """The osdmap epoch of the COMMITTED value — what map sends
        actually serve.  (The live map may be mid-mutation ahead of it
        while a propose is in flight; serving decisions keyed on the
        live epoch could overtrack a subscriber past an epoch it never
        received.)"""
        return self._committed_json.get("osdmap", {}).get("epoch", 0)

    def _full_payload_size(self) -> int:
        """Serialized size of the current full-map payload, cached per
        epoch: the full-publish-equivalent accounting must not itself
        pay the serialization keepalives exist to avoid."""
        with self.lock:
            epoch = self._committed_epoch()
            if self._full_size_cache[0] == epoch:
                return self._full_size_cache[1]
            size = len(json.dumps(self._map_payload()))
            self._full_size_cache = (epoch, size)
            return size

    def _inc_chain(self, have: int, epoch: int) -> list | None:
        """The ring's delta chain covering (have, epoch], oldest
        first, or None when the ring cannot reach `have` exactly (gap
        -> caller sends a full)."""
        if have <= 0 or have >= epoch:
            return None
        chain: list = []
        e = epoch
        with self.lock:
            while e > have:
                inc = self._inc_ring.get(e)
                if inc is None:
                    return None
                chain.append(inc)
                e = inc["prev"]
        if e != have:
            return None     # a catch-up delta jumped past `have`
        chain.reverse()
        return chain

    def _send_map_update(self, conn, have: int) -> None:
        """One subscriber's map update: keepalive ack when current,
        delta chain when the ring covers it, full map otherwise
        (reference OSDMonitor::send_incremental).  Tracks the epoch
        optimistically; the subscriber's next have_epoch corrects."""
        with self.lock:
            epoch = self._committed_epoch()
            config = self._committed_json.get("config", {})
        if have >= epoch > 0:
            conn.send_message(M.MOSDMapInc(epoch=epoch, config=config))
            self.perf.inc("map_keepalive_sends")
            self.perf.inc("map_full_equiv_bytes",
                          self._full_payload_size())
            return
        chain = self._inc_chain(have, epoch)
        if chain is not None:
            msg = M.MOSDMapInc(epoch=epoch, incs=chain, config=config)
            conn.send_message(msg)
            self.perf.inc("map_inc_sends")
            self.perf.inc("map_inc_bytes", len(msg.data_segment()))
        else:
            conn.send_message(M.MMonMap(self._map_payload()))
            self.perf.inc("map_full_sends")
            self.perf.inc("map_full_bytes", self._full_payload_size())
        self.perf.inc("map_full_equiv_bytes", self._full_payload_size())
        with self.lock:
            if conn in self._subscribers:
                self._subscribers[conn] = epoch

    def map_stats(self) -> dict:
        """Map-distribution ledger (the `osdmap status` asok payload
        and the --scale bench's gate source)."""
        with self.lock:
            ring = sorted(self._inc_ring)
            n_subs = len(self._subscribers)
            epoch = self.osdmap.epoch
        d = self.perf.dump()
        actual = d["map_full_bytes"] + d["map_inc_bytes"]
        commit = d["map_commit"]
        return {
            "epoch": epoch,
            "subscribers": n_subs,
            "ring": {"len": len(ring),
                     "from": ring[0] if ring else None,
                     "to": ring[-1] if ring else None},
            "epochs_committed": d["map_epochs"],
            "sends": {"full": d["map_full_sends"],
                      "inc": d["map_inc_sends"],
                      "keepalive": d["map_keepalive_sends"]},
            "bytes": {"full": d["map_full_bytes"],
                      "inc": d["map_inc_bytes"],
                      "shipped": actual,
                      "full_equiv": d["map_full_equiv_bytes"]},
            "bytes_saved_ratio": round(
                d["map_full_equiv_bytes"] / actual, 2) if actual
            else None,
            "batched_mutations": d["map_batched_mutations"],
            "commit": {"count": commit["avgcount"],
                       "avg_ms": round(commit["avgtime"] * 1e3, 3)},
        }

    def _leader_conn(self):
        return self.messenger.connect(self.mon_addrs[self.paxos.leader])

    # -- dispatch -----------------------------------------------------------

    def _peer_kind(self, conn) -> str | None:
        """Authenticated peer category: 'service' for cluster daemons,
        'client_key'/'ticket' for clients, None when auth is off."""
        if self.auth is None:
            return None
        ident = getattr(conn.session, "auth_identity", None)
        return ident.get("kind") if ident else "none"

    def _dispatch(self, conn, msg) -> None:
        kind = self._peer_kind(conn)
        # privilege fence: consensus and daemon lifecycle traffic is
        # cluster-internal — only service-keyed peers may speak it
        # (reference MonCap service caps on mon/osd messages)
        if kind is not None and kind != "service" and isinstance(
                msg, (M.MMonPaxos, M.MOSDBoot, M.MOSDFailure,
                      M.MOSDSlowOpReport, M.MPGStats)):
            return
        if isinstance(msg, M.MMonPaxos):
            # paxos peers must be monitors, not arbitrary daemons
            ident = getattr(conn.session, "auth_identity", None)
            if kind == "service" and ident and \
                    ident.get("entity") != "mon":
                return
            if msg.op in ("propose", "ack", "victory"):
                self.election.handle(msg.rank, msg.op, msg.epoch,
                                     msg.quorum)
            else:
                self.paxos.handle(msg.rank, msg.op, pn=msg.pn,
                                  value=msg.value,
                                  committed=msg.committed,
                                  uncommitted=msg.uncommitted,
                                  epoch=msg.epoch)
        elif isinstance(msg, M.MMonGetMap):
            # have_epoch is the subscriber's authoritative state — it
            # overrides our optimistic tracking (and a 0 from an older
            # sender or a gap-recovering daemon forces a full map)
            have = getattr(msg, "have_epoch", 0)
            with self.lock:
                self._subscribers[conn] = have
            # lease reads only: a mon outside the quorum (partitioned,
            # electing) must not serve a possibly-stale map — silence
            # makes daemons/clients hunt to a live mon (reference
            # Paxos::is_lease_valid gating on reads)
            if self._lease_ok():
                try:
                    self._send_map_update(conn, have)
                except Exception:  # noqa: BLE001 - dead conn
                    with self.lock:
                        self._subscribers.pop(conn, None)
        elif isinstance(msg, M.MOSDBoot):
            if self.is_leader:
                self._handle_boot(msg)
            else:
                self._forward(msg)
        elif isinstance(msg, M.MOSDFailure):
            if self.is_leader:
                self._handle_failure(msg)
            else:
                self._forward(msg)
        elif isinstance(msg, M.MOSDSlowOpReport):
            if self.is_leader:
                self._handle_slow_op_report(msg)
            else:
                self._forward(msg)
        elif isinstance(msg, M.MPGStats):
            if self.is_leader:
                self._handle_pg_stats(msg)
            else:
                self._forward(msg)
        elif isinstance(msg, M.MAuth):
            self._handle_auth(conn, msg)
        elif isinstance(msg, M.MMonCommand):
            prefix = msg.cmd.get("prefix", "")
            if not self._caps_allow(conn, prefix):
                conn.send_message(M.MMonCommandAck(
                    msg.tid, -errno.EACCES, {"error": "caps deny"}))
            elif self.is_leader or (prefix in READONLY_COMMANDS and
                                    prefix not in LEADER_ONLY_READS and
                                    self._lease_ok()):
                result, out = self._timed_handle_command(prefix, msg.cmd)
                conn.send_message(M.MMonCommandAck(msg.tid, result, out))
            elif self.paxos.leader >= 0 and \
                    self.paxos.role == "peon":
                # forward to the leader, relay the ack back (reference
                # Monitor::forward_request_leader)
                with self.lock:
                    self._fwd_tid += 1
                    ftid = self._fwd_tid
                    self._fwd_waiters[ftid] = (conn, msg.tid,
                                               time.time())
                self._leader_conn().send_message(
                    M.MMonCommand(msg.cmd, ftid))
            else:
                conn.send_message(M.MMonCommandAck(
                    msg.tid, -errno.EAGAIN, {"error": "no quorum"}))
        elif isinstance(msg, M.MMonCommandAck):
            with self.lock:
                ent = self._fwd_waiters.pop(msg.tid, None)
            if ent is not None:
                oconn, otid, _ts = ent
                try:
                    oconn.send_message(
                        M.MMonCommandAck(otid, msg.result, msg.out))
                except Exception:  # noqa: BLE001
                    pass

    def _forward(self, msg) -> None:
        if self.paxos.leader >= 0 and self.paxos.leader != self.rank:
            try:
                self._leader_conn().send_message(msg)
            except Exception:  # noqa: BLE001
                pass

    # -- auth (reference AuthMonitor + cephx ticket service) ----------------

    def _caps_allow(self, conn, prefix: str) -> bool:
        """Minimal caps model: daemons and 'allow *' entities do
        anything; 'allow r' entities only read (reference MonCap is a
        full grammar; this is the subset the keyring writes)."""
        if self.auth is None:
            return True
        ident = getattr(conn.session, "auth_identity", None)
        if ident is None:
            return False
        caps = ident.get("caps", "")
        if "allow *" in caps:
            return True
        return prefix in READONLY_COMMANDS and "allow r" in caps

    def _handle_auth(self, conn, msg: M.MAuth) -> None:
        from ..auth import cephx
        if self.auth is None or self.auth.keyring is None or \
                self.auth.service_key is None:
            conn.send_message(M.MAuthReply(msg.tid, -errno.EOPNOTSUPP))
            return
        ident = getattr(conn.session, "auth_identity", None)
        key = self.auth.keyring.get(msg.entity)
        # the ticket goes only to the entity the CONNECTION proved
        if ident is None or ident["entity"] != msg.entity or key is None:
            conn.send_message(M.MAuthReply(msg.tid, -errno.EPERM))
            return
        import base64
        caps = self.auth.keyring.caps.get(msg.entity, "allow *")
        ttl = 3600.0
        expires = time.time() + ttl
        ticket, skey = cephx.issue_ticket(
            self.auth.service_key, msg.entity, caps, ttl=ttl)
        sealed = cephx.seal(key, {
            "session_key": base64.b64encode(skey).decode(),
            "expires": expires})
        conn.send_message(M.MAuthReply(msg.tid, 0, ticket, sealed))

    # -- osd lifecycle (leader only) ----------------------------------------

    def _handle_boot(self, msg: M.MOSDBoot) -> None:
        with self.lock:
            info = self.osdmap.osds.get(msg.osd_id)
            if info is not None and info.up and \
                    tuple(info.addr or ()) == tuple(msg.addr or ()):
                return   # idempotent re-boot (keepalive rotation)
            if msg.osd_id not in self.osdmap.osds:
                # auto-create with one host per osd unless pre-declared
                self.osdmap.add_osd(msg.osd_id, f"host{msg.osd_id}",
                                    addr=msg.addr)
            self.osdmap.set_osd_up(msg.osd_id, msg.addr)
            self._failure_reports.pop(msg.osd_id, None)
        # fire-and-forget mutation: a cold-start boot storm commits as
        # one epoch per batch window, not one per OSD
        self._commit_batched()

    def _handle_failure(self, msg: M.MOSDFailure) -> None:
        with self.lock:
            if not self.osdmap.is_up(msg.failed):
                return
            reports = self._failure_reports.setdefault(msg.failed, set())
            reports.add(msg.reporter)
            up = sum(1 for o in self.osdmap.osds.values() if o.up)
            need = min(self.failure_quorum, max(1, up - 1))
            if len(reports) >= need:
                self.osdmap.set_osd_down(msg.failed)
                self._failure_reports.pop(msg.failed, None)
                marked = True
            else:
                marked = False
        if marked:
            # a host's worth of failure reports arriving in a burst
            # coalesces into one mark-down epoch
            self._commit_batched()

    def _handle_slow_op_report(self, msg: M.MOSDSlowOpReport) -> None:
        """An OSD's tracker latched (or cleared) slow ops (reference:
        the osd->mgr->mon health path behind the SLOW_OPS warning)."""
        with self.lock:
            if msg.report.get("count"):
                self.slow_op_reports[msg.osd_id] = {
                    **msg.report, "ts": time.time()}
            else:
                self.slow_op_reports.pop(msg.osd_id, None)

    def _handle_pg_stats(self, msg: M.MPGStats) -> None:
        """An OSD's periodic PG-state summary (reference MPGStats via
        the mgr, reduced to the mon directly)."""
        with self.lock:
            self.pg_stat_reports[msg.osd_id] = {
                **msg.report, "ts": time.time()}

    def _fresh_pg_stats(self) -> dict[int, dict]:
        """Reports younger than PG_STAT_FRESH; stale ones are pruned
        (a dead OSD must not pin degraded counts — its PGs' state is
        re-reported by the primaries that take over)."""
        now = time.time()
        with self.lock:
            for osd in [o for o, r in self.pg_stat_reports.items()
                        if now - r["ts"] > PG_STAT_FRESH]:
                del self.pg_stat_reports[osd]
            return {o: dict(r) for o, r in self.pg_stat_reports.items()}

    def _complete_pg_stats(self) -> tuple[dict[int, dict], list[int]]:
        """(fresh stats, up OSDs with NO fresh report).  Safety gates
        (ok-to-stop, safe-to-destroy, the interleave guard) need a
        COMPLETE cluster view: right after a leader failover the new
        leader's report table starts empty, and judging from a partial
        view would read silence as health."""
        stats = self._fresh_pg_stats()
        with self.lock:
            missing = sorted(o.id for o in self.osdmap.osds.values()
                             if o.up and o.id not in stats)
        return stats, missing

    def _drain_tick(self) -> None:
        """Leader maintenance: walk each draining OSD's weight toward
        0, one step per tick, each a committed map epoch — CRUSH
        remaps a slice of PGs per step and the existing recovery
        machinery backfills them out (reference: gradual `osd
        reweight` walks in ceph-volume/drain tooling)."""
        with self.lock:
            todo = [(o, s) for o, s in self._draining.items()]
            if not todo:
                return
            changed = False
            for osd_id, step in todo:
                info = self.osdmap.osds.get(osd_id)
                if info is None or info.weight <= 0.0:
                    del self._draining[osd_id]
                    continue
                self.osdmap.set_osd_weight(
                    osd_id, max(0.0, round(info.weight - step, 6)))
                changed = True
            if changed:
                self.osdmap.bump_epoch()
                self._propose_current()

    # -- admin commands (reference OSDMonitor command surface) --------------

    def _timed_handle_command(self, prefix: str, cmd: dict
                              ) -> tuple[int, dict]:
        """handle_command behind the dispatch ledger: depth gauge up
        on entry / down on exit, wall-clock into lat_mon_dispatch and
        a per-prefix histogram.  The depth gauge reads >1 exactly when
        the messenger's dispatch threads queue behind the mon lock —
        the single-threaded-dispatch suspicion ROADMAP item 4 names,
        now measurable instead of argued about."""
        self.perf.inc("mon_dispatch_depth")
        t0 = time.perf_counter()
        try:
            return self.handle_command(cmd)
        finally:
            dt = time.perf_counter() - t0
            self.perf.inc("mon_dispatch_depth", -1)
            self.perf.inc("mon_commands")
            self.perf.hinc("lat_mon_dispatch", dt)
            key = (prefix or "none").replace(" ", "_").replace("-", "_")
            self.perf.hinc(f"lat_mon_dispatch_{key}", dt)

    def handle_command(self, cmd: dict) -> tuple[int, dict]:
        prefix = cmd.get("prefix", "")
        try:
            if prefix == "osd erasure-code-profile set":
                return self._cmd_profile_set(cmd)
            if prefix == "osd erasure-code-profile get":
                name = cmd["name"]
                prof = self.osdmap.ec_profiles.get(name)
                return (0, {"profile": prof}) if prof is not None else \
                    (-errno.ENOENT, {"error": f"no profile {name}"})
            if prefix == "osd erasure-code-profile ls":
                return 0, {"profiles": sorted(self.osdmap.ec_profiles)}
            if prefix == "osd pool create":
                return self._cmd_pool_create(cmd)
            if prefix == "osd pool set":
                return self._cmd_pool_set(cmd)
            if prefix == "osd pool get":
                return self._cmd_pool_get(cmd)
            if prefix == "osd pool ls":
                return 0, {"pools": [p.name
                                     for p in self.osdmap.pools.values()]}
            if prefix == "osd out":
                osd_id = int(cmd["id"])
                with self.lock:
                    self.osdmap.set_osd_out(osd_id)
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"out": osd_id}
            if prefix == "osd in":
                osd_id = int(cmd["id"])
                with self.lock:
                    if osd_id in self.osdmap.osds:
                        self.osdmap.osds[osd_id].in_ = True
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"in": osd_id}
            if prefix == "osd reweight":
                osd_id = int(cmd["id"])
                weight = float(cmd["weight"])
                with self.lock:
                    if osd_id not in self.osdmap.osds:
                        return -errno.ENOENT, {"error": f"no osd.{osd_id}"}
                    try:
                        self.osdmap.set_osd_weight(osd_id, weight)
                    except ValueError as e:
                        return -errno.EINVAL, {"error": str(e)}
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"osd": osd_id, "weight": weight}
            if prefix == "osd drain":
                return self._cmd_osd_drain(cmd)
            if prefix == "osd ok-to-stop":
                return self._cmd_ok_to_stop(cmd)
            if prefix == "osd safe-to-destroy":
                return self._cmd_safe_to_destroy(cmd)
            if prefix == "osd rm":
                return self._cmd_osd_rm(cmd)
            if prefix == "pg stat":
                return self._cmd_pg_stat()
            if prefix == "progress":
                return self._cmd_progress()
            if prefix == "progress update":
                return self._cmd_progress_update(cmd)
            if prefix in ("osd mclock profile set",
                          "osd mclock profile get"):
                return self._cmd_mclock_profile(prefix, cmd)
            if prefix == "osd blacklist add":
                entity = str(cmd["entity"])
                ttl = float(cmd.get("expire", 3600.0))
                import time as _time
                with self.lock:
                    # prune expired entries while we hold the map
                    now = _time.time()
                    self.osdmap.blacklist = {
                        e: t for e, t in self.osdmap.blacklist.items()
                        if t > now}
                    self.osdmap.blacklist[entity] = now + ttl
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"blacklisted": entity,
                           "epoch": self.osdmap.epoch}
            if prefix == "osd blacklist rm":
                entity = str(cmd["entity"])
                with self.lock:
                    if entity not in self.osdmap.blacklist:
                        return -errno.ENOENT, {"error": entity}
                    del self.osdmap.blacklist[entity]
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"removed": entity}
            if prefix == "osd blacklist ls":
                return 0, {"blacklist": dict(self.osdmap.blacklist)}
            if prefix == "osd down":
                osd_id = int(cmd["id"])
                with self.lock:
                    self.osdmap.set_osd_down(osd_id)
                    self._failure_reports.pop(osd_id, None)
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"down": osd_id}
            if prefix == "osd pg-temp":
                # explicit acting-set override (reference OSDMonitor
                # pg-temp; the balancer's upmap-role lever)
                pgid = pg_t(*cmd["pgid"])
                osds = [int(o) for o in cmd["osds"]]
                with self.lock:
                    if pgid.pool not in self.osdmap.pools:
                        return -errno.ENOENT, {"error": f"no pool {pgid.pool}"}
                    if osds:
                        self.osdmap.pg_temp[pgid] = osds
                    else:
                        self.osdmap.pg_temp.pop(pgid, None)
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"pg_temp": [str(pgid), osds]}
            if prefix == "osd pg-upmap-items":
                # fine-grained mapping override (reference OSDMonitor
                # osd pg-upmap-items; consumed by the balancer)
                pgid = pg_t(*cmd["pgid"])
                raw_pairs = cmd["pairs"]
                if any(len(p) != 2 for p in raw_pairs):
                    return -errno.EINVAL, {
                        "error": "pairs must be [from, to] twos"}
                pairs = [tuple(int(x) for x in p) for p in raw_pairs]
                tos = [t for _f, t in pairs]
                if len(set(tos)) != len(tos):
                    return -errno.EINVAL, {
                        "error": "duplicate upmap targets"}
                with self.lock:
                    if pgid.pool not in self.osdmap.pools:
                        return -errno.ENOENT, {
                            "error": f"no pool {pgid.pool}"}
                    bad = [p for p in pairs
                           if p[1] not in self.osdmap.osds]
                    if bad:
                        return -errno.ENOENT, {
                            "error": f"unknown target osds {bad}"}
                    if pairs:
                        self.osdmap.pg_upmap_items[pgid] = pairs
                    else:
                        self.osdmap.pg_upmap_items.pop(pgid, None)
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"pg_upmap_items": [str(pgid), pairs]}
            if prefix == "osd rm-pg-upmap-items":
                pgid = pg_t(*cmd["pgid"])
                with self.lock:
                    self.osdmap.pg_upmap_items.pop(pgid, None)
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"removed": str(pgid)}
            if prefix == "osd pool selfmanaged-snap-create":
                # allocate one snap id (reference OSDMonitor
                # prepare_pool_op SELFMANAGED_SNAP_CREATE)
                name = cmd["pool"]
                with self.lock:
                    pool = self.osdmap.lookup_pool(name)
                    if pool is None:
                        return -errno.ENOENT, {"error": f"no pool {name}"}
                    pool.snap_seq += 1
                    snapid = pool.snap_seq
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"snapid": snapid}
            if prefix == "osd pool selfmanaged-snap-rm":
                name = cmd["pool"]
                snapid = int(cmd["snapid"])
                with self.lock:
                    pool = self.osdmap.lookup_pool(name)
                    if pool is None:
                        return -errno.ENOENT, {"error": f"no pool {name}"}
                    if snapid not in pool.removed_snaps:
                        pool.removed_snaps.append(snapid)
                    self.osdmap.bump_epoch()
                    self._propose_current()
                return 0, {"removed": snapid}
            if prefix == "status":
                return self._cmd_status()
            if prefix == "health":
                return self._cmd_health()
            if prefix == "osd tree":
                return self._cmd_tree()
            if prefix == "mon stat":
                return 0, self.quorum_status()
            if prefix.startswith("auth "):
                return self._cmd_auth(prefix, cmd)
            if prefix.startswith("config "):
                return self._cmd_config(prefix, cmd)
            if prefix.startswith("fs ") or prefix == "mds boot":
                return self._cmd_fs(prefix, cmd)
            if prefix.startswith("mgr "):
                return self._cmd_mgr(prefix, cmd)
            return -errno.EINVAL, {"error": f"unknown command {prefix!r}"}
        except ErasureCodeError as e:
            return -e.errno, {"error": str(e)}
        except KeyError as e:
            return -errno.EINVAL, {"error": f"missing arg {e}"}

    def _cmd_mclock_profile(self, prefix: str, cmd: dict
                            ) -> tuple[int, dict]:
        """mClock QoS profile get/set (reference `ceph config set osd
        osd_mclock_profile ...` sugar): the set lands in the central
        config 'osd' section and rides the next map publish to every
        running OSD (docs/QOS.md); get reports the stored knobs AND
        the per-class (reservation, weight, limit) triples they
        resolve to."""
        from ..osd.scheduler import (MCLOCK_PROFILES,
                                     parse_custom_profile,
                                     profiles_from_conf)
        if prefix == "osd mclock profile set":
            name = str(cmd.get("profile", ""))
            if name not in (*MCLOCK_PROFILES, "custom"):
                return -errno.EINVAL, {
                    "error": f"unknown profile {name!r}",
                    "known": sorted((*MCLOCK_PROFILES, "custom"))}
            custom = cmd.get("custom")
            if custom:
                try:
                    parse_custom_profile(str(custom))
                except ValueError as e:
                    return -errno.EINVAL, {"error": str(e)}
            with self.lock:
                osd_sec = self.config_db.setdefault("osd", {})
                osd_sec["osd_mclock_profile"] = name
                if custom is not None:
                    if custom:
                        osd_sec["osd_mclock_custom_profile"] = \
                            str(custom)
                    else:
                        osd_sec.pop("osd_mclock_custom_profile", None)
                self._propose_current()
            return 0, {"profile": name,
                       "custom": osd_sec.get(
                           "osd_mclock_custom_profile", "")}
        # get: the effective resolution a fresh OSD would compute
        osd_sec = self.config_db.get("osd", {})
        name = osd_sec.get("osd_mclock_profile", "balanced")
        custom = osd_sec.get("osd_mclock_custom_profile", "")

        class _ConfView:
            def get(self, key):
                return {"osd_mclock_profile": name,
                        "osd_mclock_custom_profile": custom}[key]
        resolved = profiles_from_conf(_ConfView())
        return 0, {"profile": name, "custom": custom,
                   "classes": {c: {"reservation": p.reservation,
                                   "weight": p.weight,
                                   "limit": p.limit}
                               for c, p in resolved.items()}}

    # -- PaxosService command surfaces (auth/config/fs/mgr) -----------------

    def _cmd_auth(self, prefix: str, cmd: dict) -> tuple[int, dict]:
        """AuthMonitor role (reference src/mon/AuthMonitor.cc): entity
        create/list/remove ride Paxos so every mon serves the same
        keyring and it survives restarts."""
        import base64
        if prefix == "auth get-or-create":
            entity = cmd["entity"]
            caps = cmd.get("caps", "allow *")
            with self.lock:
                key = self.keyring.get(entity)
                if key is None:
                    key = self.keyring.gen_key(entity, caps)
                    self._propose_current()
                elif caps != self.keyring.caps.get(entity):
                    self.keyring.caps[entity] = caps
                    self._propose_current()
            return 0, {"entity": entity,
                       "key": base64.b64encode(key).decode(),
                       "caps": self.keyring.caps.get(entity, "")}
        if prefix == "auth get":
            entity = cmd["entity"]
            key = self.keyring.get(entity)
            if key is None:
                return -errno.ENOENT, {"error": f"no entity {entity}"}
            return 0, {"entity": entity,
                       "key": base64.b64encode(key).decode(),
                       "caps": self.keyring.caps.get(entity, "")}
        if prefix == "auth ls":
            return 0, {"entities": [
                {"entity": e, "caps": self.keyring.caps.get(e, "")}
                for e in self.keyring.entities()]}
        if prefix == "auth rm":
            entity = cmd["entity"]
            with self.lock:
                if entity not in self.keyring:
                    return -errno.ENOENT, {"error": f"no entity {entity}"}
                self.keyring.remove(entity)
                self._propose_current()
            return 0, {"removed": entity}
        return -errno.EINVAL, {"error": f"unknown command {prefix!r}"}

    def _cmd_config(self, prefix: str, cmd: dict) -> tuple[int, dict]:
        """ConfigMonitor role (reference src/mon/ConfigMonitor.cc): a
        replicated cluster config DB keyed section/name ('global',
        'osd', 'osd.3', ... like the reference's config tree)."""
        if prefix == "config set":
            sec, name = cmd["section"], cmd["name"]
            with self.lock:
                self.config_db.setdefault(sec, {})[name] = \
                    str(cmd["value"])
                self._propose_current()
            return 0, {"set": [sec, name]}
        if prefix == "config rm":
            sec, name = cmd["section"], cmd["name"]
            with self.lock:
                if self.config_db.get(sec, {}).pop(name, None) is None:
                    return -errno.ENOENT, {"error": f"no {sec}/{name}"}
                if not self.config_db[sec]:
                    del self.config_db[sec]
                self._propose_current()
            return 0, {"removed": [sec, name]}
        if prefix == "config get":
            sec = cmd["section"]
            name = cmd.get("name")
            d = self.config_db.get(sec, {})
            if name is not None:
                if name not in d:
                    return -errno.ENOENT, {"error": f"no {sec}/{name}"}
                return 0, {"value": d[name]}
            return 0, {"config": dict(d)}
        if prefix == "config dump":
            return 0, {"config": {s: dict(d)
                                  for s, d in self.config_db.items()}}
        return -errno.EINVAL, {"error": f"unknown command {prefix!r}"}

    def _cmd_fs(self, prefix: str, cmd: dict) -> tuple[int, dict]:
        """MDSMonitor role (reference src/mon/MDSMonitor.cc + FSMap):
        filesystems and their MDS ranks live in a replicated fsmap."""
        if prefix == "fs new":
            name = cmd["name"]
            meta, data = cmd["metadata_pool"], cmd["data_pool"]
            with self.lock:
                if name in self.fsmap["filesystems"]:
                    return -errno.EEXIST, {"error": f"fs {name} exists"}
                for p in (meta, data):
                    if self.osdmap.lookup_pool(p) is None:
                        return -errno.ENOENT, {"error": f"no pool {p}"}
                self.fsmap["filesystems"][name] = {
                    "metadata_pool": meta, "data_pool": data, "mds": {}}
                self.fsmap["epoch"] += 1
                self._propose_current()
            return 0, {"fs": name}
        if prefix == "fs rm":
            name = cmd["name"]
            with self.lock:
                if name not in self.fsmap["filesystems"]:
                    return -errno.ENOENT, {"error": f"no fs {name}"}
                del self.fsmap["filesystems"][name]
                self.fsmap["epoch"] += 1
                self._propose_current()
            return 0, {"removed": name}
        if prefix == "fs ls":
            return 0, {"filesystems":
                       sorted(self.fsmap["filesystems"])}
        if prefix == "fs dump":
            return 0, copy.deepcopy(self.fsmap)
        if prefix == "fs set max_mds":
            name = cmd["name"]
            with self.lock:
                if name not in self.fsmap["filesystems"]:
                    return -errno.ENOENT, {"error": f"no fs {name}"}
                self.fsmap["filesystems"][name]["max_mds"] = \
                    int(cmd["max_mds"])
                self.fsmap["epoch"] += 1
                self._propose_current()
            return 0, {"max_mds": int(cmd["max_mds"])}
        if prefix == "mds boot":
            mds_name = cmd["name"]
            fs_name = cmd.get("fs")
            with self.lock:
                fss = self.fsmap["filesystems"]
                if fs_name is None and len(fss) == 1:
                    fs_name = next(iter(fss))
                if fs_name not in fss:
                    return -errno.ENOENT, {"error": f"no fs {fs_name}"}
                # active while the fs has active slots (max_mds,
                # reference FSMap promotion); a restarting MDS re-takes
                # its slot, extra MDSes become standby
                max_mds = int(fss[fs_name].get("max_mds", 1))
                others_active = sum(
                    1 for n, e in fss[fs_name]["mds"].items()
                    if n != mds_name and e["state"] == "active")
                state = "active" if others_active < max_mds \
                    else "standby"
                fss[fs_name]["mds"][mds_name] = {
                    "addr": list(cmd.get("addr") or ()),
                    "state": state}
                self.fsmap["epoch"] += 1
                self._propose_current()
            return 0, {"fs": fs_name,
                       "state": fss[fs_name]["mds"][mds_name]["state"]}
        return -errno.EINVAL, {"error": f"unknown command {prefix!r}"}

    def _cmd_mgr(self, prefix: str, cmd: dict) -> tuple[int, dict]:
        """MgrMonitor role (reference src/mon/MgrMonitor.cc): active/
        standby mgr tracking in a replicated mgrmap."""
        if prefix == "mgr boot":
            name = cmd["name"]
            with self.lock:
                if self.mgrmap["active"] is None:
                    self.mgrmap["active"] = name
                elif self.mgrmap["active"] != name and \
                        name not in self.mgrmap["standbys"]:
                    self.mgrmap["standbys"].append(name)
                else:
                    return 0, self._mgr_role(name)   # idempotent re-boot
                self.mgrmap["epoch"] += 1
                self._propose_current()
            return 0, self._mgr_role(name)
        if prefix == "mgr fail":
            with self.lock:
                if self.mgrmap["active"] is None:
                    return -errno.ENOENT, {"error": "no active mgr"}
                failed = self.mgrmap["active"]
                self.mgrmap["active"] = (self.mgrmap["standbys"].pop(0)
                                         if self.mgrmap["standbys"]
                                         else None)
                self.mgrmap["epoch"] += 1
                self._propose_current()
            return 0, {"failed": failed,
                       "active": self.mgrmap["active"]}
        if prefix == "mgr dump":
            return 0, copy.deepcopy(self.mgrmap)
        return -errno.EINVAL, {"error": f"unknown command {prefix!r}"}

    def _mgr_role(self, name: str) -> dict:
        return {"name": name,
                "role": "active" if self.mgrmap["active"] == name
                else "standby"}

    # -- drain / decommission (reference OSDMonitor `osd ok-to-stop`
    #    :3870, `osd safe-to-destroy` :3760, `osd rm`) ----------------------

    def _cmd_osd_drain(self, cmd: dict) -> tuple[int, dict]:
        """Begin a graceful drain: walk the OSD's reweight down to 0
        in `step` increments, one committed epoch per maintenance
        tick, so backfill-out proceeds in slices instead of one
        recovery storm.  `osd safe-to-destroy` turning safe is the
        completion signal; `osd rm` finishes the decommission."""
        osd_id = int(cmd["id"])
        step = float(cmd.get("step", 0.25))
        if not 0.0 < step <= 1.0:
            return -errno.EINVAL, {
                "error": f"drain step {step} not in (0, 1]"}
        with self.lock:
            info = self.osdmap.osds.get(osd_id)
            if info is None:
                return -errno.ENOENT, {"error": f"no osd.{osd_id}"}
            self._draining[osd_id] = step
        return 0, {"draining": osd_id, "step": step,
                   "weight": info.weight}

    def _stop_would_break(self, osd_ids: set[int]) -> list[str]:
        """PGs that would drop below min_size if osd_ids all stopped
        (reference OSDMonitor::check_pg_num / ok-to-stop logic)."""
        from ..crush.map import CRUSH_ITEM_NONE
        blocked: list[str] = []
        for pool in self.osdmap.pools.values():
            for seed in range(pool.pg_num):
                pgid = pg_t(pool.id, seed)
                try:
                    _, acting, _, _ = \
                        self.osdmap.pg_to_up_acting_osds(pgid)
                except Exception:  # noqa: BLE001 - unmapped pg
                    continue
                live = [o for o in acting if o != CRUSH_ITEM_NONE and
                        self.osdmap.is_up(o)]
                if not any(o in osd_ids for o in live):
                    continue
                remain = sum(1 for o in live if o not in osd_ids)
                if remain < pool.min_size:
                    blocked.append(str(pgid))
        return blocked

    def _cmd_ok_to_stop(self, cmd: dict) -> tuple[int, dict]:
        """Would stopping these OSDs leave every PG at or above
        min_size, with no unfound-adjacent data at risk?  Refusal
        names the blocking PGs (reference `osd ok-to-stop`)."""
        ids = {int(i) for i in
               (cmd["ids"] if "ids" in cmd else [cmd["id"]])}
        with self.lock:
            unknown = [i for i in ids if i not in self.osdmap.osds]
            if unknown:
                return -errno.ENOENT, {"error": f"no osd {unknown}"}
            blocked = self._stop_would_break(ids)
        if blocked:
            return -errno.EBUSY, {
                "ok_to_stop": False,
                "blocked_by": blocked[:16],
                "error": f"{len(blocked)} pgs would drop below "
                         f"min_size"}
        # unfound-adjacent guard: while ANY object is unfound, a
        # not-yet-consulted holder may be the last copy — refuse to
        # shrink the holder set further (conservative superset of the
        # reference's per-pg missing_loc check).  Incomplete stats =
        # we CANNOT rule unfound out (fresh leader, first interval
        # after boot) — refuse rather than treat silence as health.
        stats, unreported = self._complete_pg_stats()
        if unreported:
            return -errno.EAGAIN, {
                "ok_to_stop": False,
                "error": f"no fresh pg stats from up osds "
                         f"{unreported}; cannot verify no unfound "
                         f"objects"}
        unfound = sum(r.get("unfound", 0) for r in stats.values())
        if unfound:
            return -errno.EBUSY, {
                "ok_to_stop": False,
                "error": f"{unfound} objects unfound; stopping more "
                         f"osds could destroy the last copy"}
        return 0, {"ok_to_stop": True}

    def _cmd_safe_to_destroy(self, cmd: dict) -> tuple[int, dict]:
        """May this OSD's data be destroyed without risk?  Safe iff no
        PG maps to it under the current map AND fresh pg stats show
        the cluster fully recovered (no degraded/misplaced/unfound
        objects anywhere — so nothing could still need this OSD as a
        backfill source).  Reference `osd safe-to-destroy`."""
        from ..crush.map import CRUSH_ITEM_NONE
        osd_id = int(cmd["id"])
        with self.lock:
            if osd_id not in self.osdmap.osds:
                return -errno.ENOENT, {"error": f"no osd.{osd_id}"}
            mapped = []
            for pool in self.osdmap.pools.values():
                for seed in range(pool.pg_num):
                    pgid = pg_t(pool.id, seed)
                    try:
                        up, acting, _, _ = \
                            self.osdmap.pg_to_up_acting_osds(pgid)
                    except Exception:  # noqa: BLE001
                        continue
                    if osd_id in up or osd_id in acting:
                        mapped.append(str(pgid))
        if mapped:
            return -errno.EBUSY, {
                "safe": False, "pgs": mapped[:16],
                "error": f"osd.{osd_id} still maps {len(mapped)} pgs "
                         f"(drain not finished)"}
        stats, unreported = self._complete_pg_stats()
        if unreported:
            return -errno.EAGAIN, {
                "safe": False,
                "error": f"no fresh pg stats from up osds "
                         f"{unreported}; cannot verify recovery"}
        if not stats:
            return -errno.EAGAIN, {
                "safe": False,
                "error": "no fresh pg stats; cannot verify recovery"}
        deg = sum(r.get("degraded_pgs", 0) for r in stats.values())
        mis = sum(r.get("misplaced", 0) for r in stats.values())
        unf = sum(r.get("unfound", 0) for r in stats.values())
        rec = sum(r.get("recovering", 0) for r in stats.values())
        if deg or mis or unf or rec:
            # `rec` closes a window: a recovery pass mid-pull hasn't
            # failed yet (so nothing is marked degraded), but this OSD
            # may be the very source it is pulling from
            return -errno.EBUSY, {
                "safe": False,
                "error": f"cluster not fully recovered "
                         f"({deg} degraded pgs, {mis} misplaced, "
                         f"{unf} unfound objects, {rec} recovery "
                         f"passes running)"}
        return 0, {"safe": True}

    def _cmd_osd_rm(self, cmd: dict) -> tuple[int, dict]:
        """Remove an OSD from the map.  Guarded: the daemon must be
        stopped (an up OSD would simply re-register on its next boot
        message) and `safe-to-destroy` must pass, unless force=true
        (the operator accepting data loss, reference --force)."""
        osd_id = int(cmd["id"])
        with self.lock:
            info = self.osdmap.osds.get(osd_id)
            if info is None:
                return -errno.ENOENT, {"error": f"no osd.{osd_id}"}
            if info.up:
                return -errno.EBUSY, {
                    "error": f"osd.{osd_id} is up; stop it first "
                             f"(osd ok-to-stop, then kill)"}
        if not cmd.get("force"):
            r, out = self._cmd_safe_to_destroy({"id": osd_id})
            if r != 0:
                return r, {**out,
                           "error": f"not safe to destroy: "
                                    f"{out.get('error')}"}
        with self.lock:
            # re-check under the lock: the OSD may have booted (a
            # concurrent MOSDBoot dispatch) since the guard above —
            # removing a live daemon from the map would leave it
            # serving while unmapped
            info = self.osdmap.osds.get(osd_id)
            if info is None:
                return -errno.ENOENT, {"error": f"no osd.{osd_id}"}
            if info.up:
                return -errno.EBUSY, {
                    "error": f"osd.{osd_id} came up mid-removal; "
                             f"stop it first"}
            self._draining.pop(osd_id, None)
            self.pg_stat_reports.pop(osd_id, None)
            self.slow_op_reports.pop(osd_id, None)
            self._failure_reports.pop(osd_id, None)
            self.osdmap.remove_osd(osd_id)
            self.osdmap.bump_epoch()
            self._propose_current()
        return 0, {"removed": osd_id, "epoch": self.osdmap.epoch}

    def _cmd_pg_stat(self) -> tuple[int, dict]:
        """Aggregate the OSDs' MPGStats reports (reference `ceph pg
        stat`): drain/merge/recovery progress as counts instead of
        quiescence polling."""
        stats = self._fresh_pg_stats()
        pools: dict[str, dict] = {}
        for rep in stats.values():
            for pid, p in rep.get("pools", {}).items():
                agg = pools.setdefault(pid, {
                    "degraded_pgs": 0, "misplaced": 0, "unfound": 0,
                    "push_seeds": []})
                agg["degraded_pgs"] += p.get("degraded_pgs", 0)
                agg["misplaced"] += p.get("misplaced", 0)
                agg["unfound"] += p.get("unfound", 0)
                agg["push_seeds"] = sorted(
                    set(agg["push_seeds"]) |
                    set(p.get("push_seeds", [])))
        with self.lock:
            num_pgs = sum(p.pg_num for p in self.osdmap.pools.values())
        return 0, {
            "num_pgs": num_pgs,
            "osds_reporting": len(stats),
            "degraded_pgs": sum(r.get("degraded_pgs", 0)
                                for r in stats.values()),
            "misplaced_objects": sum(r.get("misplaced", 0)
                                     for r in stats.values()),
            "unfound_objects": sum(r.get("unfound", 0)
                                   for r in stats.values()),
            "recovering_osds": sorted(
                o for o, r in stats.items()
                if r.get("degraded_pgs") or r.get("misplaced")),
            "pools": pools,
        }

    def _validate_profile(self, prof: dict):
        """(Profile, codec) built by the plugin itself; a `torch`
        profile that names no device is built on the mon's.  A device
        that cannot be had (CUDA without a GPU) is the command's error,
        ENODEV."""
        prof = dict(prof)
        if prof.get("plugin") == "torch" and not prof.get("device"):
            prof["device"] = self.device
        profile = Profile(prof)
        try:
            codec = ErasureCodePluginRegistry.instance().factory(
                prof["plugin"], profile)
        except RuntimeError as e:
            raise ErasureCodeError(errno.ENODEV, str(e)) from e
        return profile, codec

    def _cmd_profile_set(self, cmd: dict) -> tuple[int, dict]:
        """Validate + normalize via the plugin itself (reference
        normalize_profile, OSDMonitor.cc:7190)."""
        name = cmd["name"]
        prof = dict(cmd.get("profile", {}))
        # the card's plugin is "torch" where ceph_tpu names "jax"
        prof.setdefault("plugin", "torch")
        profile, codec = self._validate_profile(prof)
        # normalized: plugin filled defaults (k/m/technique) into profile;
        # the mon's validation device stays out of it
        normalized = dict(profile.data)
        if "device" not in prof:
            normalized.pop("device", None)
        with self.lock:
            self.osdmap.ec_profiles[name] = normalized
            self.osdmap.bump_epoch()
            self._propose_current()
        return 0, {"profile": normalized,
                   "chunk_count": codec.get_chunk_count()}

    def _cmd_pool_create(self, cmd: dict) -> tuple[int, dict]:
        name = cmd["name"]
        pg_num = int(cmd.get("pg_num", 8))
        kind = cmd.get("type", "replicated")
        with self.lock:
            if self.osdmap.lookup_pool(name) is not None:
                return -errno.EEXIST, {"error": f"pool {name} exists"}
            if kind == "erasure":
                prof_name = cmd.get("erasure_code_profile", "default")
                prof = self.osdmap.ec_profiles.get(prof_name)
                if prof is None:
                    return -errno.ENOENT, \
                        {"error": f"no profile {prof_name}"}
                profile, codec = self._validate_profile(prof)
                k = codec.get_data_chunk_count()
                n = codec.get_chunk_count()
                # stripe_width from profile stripe_unit (validated against
                # chunk size, reference OSDMonitor.cc:7211-7229)
                stripe_unit = int(profile.get("stripe_unit", "4096"))
                chunk = codec.get_chunk_size(stripe_unit * k)
                stripe_width = chunk * k
                rule_name = cmd.get("crush_rule", f"{name}_rule")
                rid = self.osdmap.crush.rule_id_by_name(rule_name)
                if rid is None:
                    rid = codec.create_rule(rule_name, self.osdmap.crush)
                # EC min_size defaults to k+1: one write-degraded shard
                # allowed, never below reconstructability (reference
                # OSDMonitor pool-create min_size for erasure pools)
                pool = self.osdmap.create_pool(
                    name, PoolType.ERASURE, size=n, pg_num=pg_num,
                    crush_rule=rid, erasure_code_profile=prof_name,
                    stripe_width=stripe_width,
                    min_size=min(k + 1, n))
            else:
                size = int(cmd.get("size", 3))
                rule_name = cmd.get("crush_rule", "replicated_rule")
                rid = self.osdmap.crush.rule_id_by_name(rule_name)
                if rid is None:
                    rid = self.osdmap.crush.add_simple_rule(
                        rule_name, "default", "host", size)
                pool = self.osdmap.create_pool(
                    name, PoolType.REPLICATED, size=size, pg_num=pg_num,
                    crush_rule=rid)
            self.osdmap.bump_epoch()
            self._propose_current()
        return 0, {"pool_id": pool.id, "stripe_width": pool.stripe_width}

    # -- pool mutation: PG split entry point (reference OSDMonitor
    #    prepare_command "osd pool set ... pg_num") ------------------------

    def _cmd_pool_set(self, cmd: dict) -> tuple[int, dict]:
        """`osd pool set <pool> <var> <val>`.  pg_num is the PG
        split/merge trigger: validated here (power-of-two stepping in
        both directions, >= 1; a decrease is additionally gated on no
        target child still mid-split), committed through Paxos as a
        map epoch every subscriber applies — OSDs split or fold their
        local collections on receipt, clients retarget by the new
        pg_num (reference OSDMonitor pg_num change; decrease landed
        in Nautilus)."""
        name = cmd["pool"]
        var = cmd["var"]
        val = cmd["val"]
        with self.lock:
            pool = self.osdmap.lookup_pool(name)
            if pool is None:
                return -errno.ENOENT, {"error": f"no pool {name}"}
            if var == "pg_autoscale_mode":
                if val not in ("on", "warn"):
                    return -errno.EINVAL, {
                        "error": f"pg_autoscale_mode must be on|warn, "
                                 f"not {val!r}"}
                pool.pg_autoscale_mode = val
                self.osdmap.bump_epoch()
                self._propose_current()
                return 0, {"pool": name, "pg_autoscale_mode": val}
            if var != "pg_num":
                return -errno.EINVAL, {
                    "error": f"unsettable pool var {var!r}"}
            try:
                n = int(val)
            except (TypeError, ValueError):
                return -errno.EINVAL, {"error": f"bad pg_num {val!r}"}
            if n == pool.pg_num:
                return 0, {"pool": name, "pg_num": n,
                           "epoch": self.osdmap.epoch}
            # structural validation FIRST (shared with the mutator —
            # one source of truth for the error strings): an invalid
            # value must answer EINVAL, never bounce off the
            # cluster-state guard below with EAGAIN/EBUSY
            from ..osd.osd_map import validate_pg_num_step
            try:
                validate_pg_num_step(pool.pg_num, n)
            except ValueError as e:
                return -errno.EINVAL, {"error": str(e)}
            if n < pool.pg_num:
                # split/merge interleave guard: while any PG of the
                # pool still has split pushes in flight (objects
                # mid-move between collections), folding children
                # away could strand data on a holder whose sweep
                # lags.  Retry once the split settles.  An INCOMPLETE
                # stats view (fresh leader, report gap) cannot rule
                # pending pushes out — refuse rather than read
                # silence as settled, like ok-to-stop/safe-to-destroy.
                stats, unreported = self._complete_pg_stats()
                if unreported:
                    return -errno.EAGAIN, {
                        "error": f"no fresh pg stats from up osds "
                                 f"{unreported}; cannot verify the "
                                 f"pool is not mid-split — retry"}
                busy = self._pool_push_pending(pool.id, stats)
                if busy:
                    return -errno.EBUSY, {
                        "error": f"pool {name} still splitting: pgs "
                                 f"{busy[:8]} have pushes pending; "
                                 f"retry after the split settles"}
            try:
                self.osdmap.set_pool_pg_num(pool.id, n)
            except ValueError as e:
                return -errno.EINVAL, {"error": str(e)}
            self.osdmap.bump_epoch()
            self._propose_current()
            return 0, {"pool": name, "pg_num": n,
                       "epoch": self.osdmap.epoch}

    def _pool_push_pending(self, pool_id: int,
                           stats: dict[int, dict]) -> list[int]:
        """Seeds of this pool's PGs that fresh OSD stats show with
        split/merge pushes still pending (the interleave-guard
        signal)."""
        seeds: set[int] = set()
        for rep in stats.values():
            p = rep.get("pools", {}).get(str(pool_id))
            if p:
                seeds |= set(p.get("push_seeds", []))
        return sorted(seeds)

    def _cmd_pool_get(self, cmd: dict) -> tuple[int, dict]:
        name = cmd["pool"]
        pool = self.osdmap.lookup_pool(name)
        if pool is None:
            return -errno.ENOENT, {"error": f"no pool {name}"}
        fields = {"pg_num": pool.pg_num, "size": pool.size,
                  "min_size": pool.min_size,
                  "pg_autoscale_mode": pool.pg_autoscale_mode,
                  "erasure_code_profile": pool.erasure_code_profile}
        var = cmd.get("var")
        if var is None:
            return 0, {"pool": name, **fields}
        if var not in fields:
            return -errno.EINVAL, {"error": f"unknown pool var {var!r}"}
        return 0, {"pool": name, var: fields[var]}

    # -- progress events (reference mgr progress module, mon-hosted
    #    store: the mgr derives events from `pg stat` and pushes them
    #    here so `status`/`progress` answer without a mgr round-trip) --

    def _prune_progress(self, now: float) -> None:
        """Drop finished events past their linger window (caller holds
        self.lock)."""
        for eid in [e for e, ev in self.progress_events.items()
                    if ev.get("finished_at") is not None
                    and now - ev["finished_at"] > PROGRESS_LINGER]:
            del self.progress_events[eid]

    def _cmd_progress_update(self, cmd: dict) -> tuple[int, dict]:
        """Upsert one progress event (mgr-pushed).  `remove: true`
        deletes; otherwise the event dict replaces whatever the id
        held.  Progress is clamped to [0, 1] and a 1.0 stamps
        finished_at so the row lingers then retires."""
        eid = str(cmd.get("id", ""))
        if not eid:
            return -errno.EINVAL, {"error": "progress event needs id"}
        now = time.time()
        with self.lock:
            if cmd.get("remove"):
                gone = self.progress_events.pop(eid, None) is not None
                return 0, {"removed": eid, "existed": gone}
            prev = self.progress_events.get(eid)
            frac = max(0.0, min(1.0, float(cmd.get("progress", 0.0))))
            ev = {
                "id": eid,
                "message": str(cmd.get("message", eid)),
                "progress": frac,
                "started_at": float(cmd.get(
                    "started_at",
                    prev["started_at"] if prev else now)),
                "updated_at": now,
                "finished_at": (
                    (prev or {}).get("finished_at") or now)
                if frac >= 1.0 else None,
            }
            self.progress_events[eid] = ev
            self._prune_progress(now)
        return 0, {"event": ev}

    def _progress_lines(self, events: list[dict]) -> list[str]:
        """reference `ceph status` progress section: one line per
        event, message + percent + elapsed."""
        out = []
        for ev in sorted(events, key=lambda e: e["started_at"]):
            end = ev["finished_at"] or ev["updated_at"]
            out.append(
                f"{ev['message']}: {ev['progress'] * 100.0:.1f}% "
                f"({end - ev['started_at']:.1f}s)")
        return out

    def _cmd_progress(self) -> tuple[int, dict]:
        now = time.time()
        with self.lock:
            self._prune_progress(now)
            events = [dict(ev) for ev in self.progress_events.values()]
        return 0, {"events": sorted(events,
                                    key=lambda e: e["started_at"]),
                   "lines": self._progress_lines(events)}

    def _cmd_status(self) -> tuple[int, dict]:
        with self.lock:
            osds = self.osdmap.osds.values()
            self._prune_progress(time.time())
            events = [dict(ev) for ev in self.progress_events.values()]
            return 0, {
                "epoch": self.osdmap.epoch,
                "num_osds": len(self.osdmap.osds),
                "num_up_osds": sum(1 for o in osds if o.up),
                "num_in_osds": sum(1 for o in self.osdmap.osds.values()
                                   if o.in_),
                "pools": len(self.osdmap.pools),
                "quorum": self.quorum_status(),
                # peons serve `status` locally but the progress store
                # is leader-only — their list is simply empty
                "progress": self._progress_lines(events),
            }

    def _cmd_health(self) -> tuple[int, dict]:
        """`ceph health` (reference HealthMonitor checks, reduced to
        the checks this build produces): SLOW_OPS from per-OSD tracker
        reports, cleared by a count-0 report or staleness (a dead OSD
        stops reporting; its stale entry must not warn forever —
        OSD-down visibility is the failure-report path's job)."""
        now = time.time()
        with self.lock:
            for osd in [o for o, r in self.slow_op_reports.items()
                        if now - r["ts"] > 120.0]:
                del self.slow_op_reports[osd]
            reports = {o: dict(r)
                       for o, r in self.slow_op_reports.items()}
        checks: dict = {}
        total = sum(r.get("count", 0) for r in reports.values())
        if total:
            oldest = max((r.get("oldest_age", 0.0)
                          for r in reports.values()), default=0.0)
            # name the op OWNERS (each op row carries its PG primary):
            # a replica's sub-op report must blame the primary whose
            # op is stuck, not the reporting daemon — reports lacking
            # attribution fall back to the reporter
            owners: set[int] = set()
            for o, r in reports.items():
                ops = r.get("ops", [])
                if not ops:
                    owners.add(o)
                for op in ops:
                    p = op.get("primary")
                    owners.add(o if p is None else p)
            daemons = ", ".join(f"osd.{o}" for o in sorted(owners))
            checks["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{total} slow ops, oldest one blocked "
                           f"for {oldest:.1f} sec, daemons "
                           f"[{daemons}] have slow ops",
                "detail": [
                    f"osd.{o}: {r.get('count')} slow ops (lifetime "
                    f"{r.get('total_slow')}): " + "; ".join(
                        f"{op.get('type')} {op.get('desc')} age "
                        f"{op.get('age')}s blamed stage "
                        f"{op.get('blamed_stage')} trace "
                        f"{op.get('trace_id')}"
                        for op in r.get("ops", []))
                    for o, r in sorted(reports.items())],
            }
        # PG_DEGRADED: redundancy below target somewhere (reference
        # PG_DEGRADED/PG_DEGRADED_FULL health checks) — drain/merge/
        # recovery progress is observable here instead of inferred
        # from quiescence polling
        pg_stats = self._fresh_pg_stats()
        deg = sum(r.get("degraded_pgs", 0) for r in pg_stats.values())
        mis = sum(r.get("misplaced", 0) for r in pg_stats.values())
        unf = sum(r.get("unfound", 0) for r in pg_stats.values())
        if deg or mis or unf:
            affected = [
                (o, r) for o, r in sorted(pg_stats.items())
                if r.get("degraded_pgs") or r.get("misplaced") or
                r.get("unfound")]

            # degraded-window ledger rides the report (osd/pg_ledger):
            # "since <timestamp>" turns "N pgs degraded" into "degraded
            # for HOW LONG" — the number an operator triages by
            def _since(r: dict) -> str:
                led = r.get("ledger")
                ts = led.get("degraded_oldest_since") \
                    if isinstance(led, dict) else None
                if not ts:
                    return ""
                stamp = time.strftime("%Y-%m-%dT%H:%M:%S",
                                      time.localtime(ts))
                return f", degraded since {stamp} ({now - ts:.1f}s ago)"
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{deg} pgs degraded, {mis} objects "
                           f"misplaced, {unf} objects unfound "
                           f"(reported by "
                           f"[{', '.join(f'osd.{o}' for o, _r in affected)}])",
                "detail": [
                    f"osd.{o}: {r.get('degraded_pgs', 0)} degraded "
                    f"pgs, {r.get('misplaced', 0)} misplaced, "
                    f"{r.get('unfound', 0)} unfound" + _since(r)
                    for o, r in affected],
            }
        # COMPILE_STORM: device-plane compile seconds (first-seen jit
        # buckets, ops/profiler.py) exceeded the conf'd budget inside
        # the storm window on some host — the known "compile stall
        # flaps OSDs / stalls launch queues" failure mode surfaced as
        # a health check instead of folklore.  Each report names its
        # worst bucket so the operator sees WHAT compiled, not just
        # that something did.  Budget rides the report (the OSD's
        # conf'd osd_ec_compile_storm_budget_s): the mon needs no
        # config of its own and mixed-conf clusters warn per-host.
        storms = [(o, r["compile"]) for o, r in pg_stats.items()
                  if isinstance(r.get("compile"), dict)
                  and r["compile"].get("compile_s", 0.0)
                  > r["compile"].get("budget_s", float("inf"))]
        if storms:
            total_s = round(sum(c["compile_s"] for _o, c in storms), 2)
            daemons = ", ".join(f"osd.{o}" for o, _c in sorted(storms))
            checks["COMPILE_STORM"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{total_s}s of device-plane compiles in "
                           f"the last "
                           f"{storms[0][1].get('window_s')}s window, "
                           f"hosts [{daemons}] over budget",
                "detail": [
                    f"osd.{o}: {c['compile_s']}s compiled "
                    f"(budget {c['budget_s']}s, "
                    f"{c.get('stalls', 0)} stalls), worst bucket "
                    f"{c.get('worst_bucket')} ({c.get('worst_s')}s)"
                    for o, c in sorted(storms)],
            }
        # MSGR_REACTOR_LAG: wire-plane reactor starvation (msg/
        # msgr_ledger.py) — a reactor's loop-lag probe fired late by
        # more than the reporter's conf'd warn threshold inside its
        # window.  Same ride-the-report pattern as COMPILE_STORM: the
        # warn threshold (ms_reactor_lag_warn_s) ships with each
        # report, so the mon needs no config and mixed-conf clusters
        # warn per-host.  Names the worst daemon/reactor so "boot RT
        # >10s" blames a starved loop instead of staying folklore.
        lags = [(o, r["msgr"]) for o, r in pg_stats.items()
                if isinstance(r.get("msgr"), dict)
                and r["msgr"].get("worst_lag_s", 0.0)
                > r["msgr"].get("warn_s", float("inf"))]
        if lags:
            worst_o, worst_m = max(
                lags, key=lambda t: t[1].get("worst_lag_s", 0.0))
            daemons = ", ".join(f"osd.{o}" for o, _m in sorted(lags))
            checks["MSGR_REACTOR_LAG"] = {
                "severity": "HEALTH_WARN",
                "summary": f"messenger reactor lag up to "
                           f"{worst_m.get('worst_lag_s')}s (worst "
                           f"osd.{worst_o} reactor "
                           f"{worst_m.get('worst_reactor')}), hosts "
                           f"[{daemons}] over threshold",
                "detail": [
                    f"osd.{o}: worst lag {m.get('worst_lag_s')}s on "
                    f"reactor {m.get('worst_reactor')} "
                    f"({m.get('lag_events', 0)} lag events in "
                    f"{m.get('window_s')}s window, warn threshold "
                    f"{m.get('warn_s')}s)"
                    for o, m in sorted(lags)],
            }
        status = "HEALTH_WARN" if checks else "HEALTH_OK"
        return 0, {"status": status, "checks": checks}

    def _cmd_tree(self) -> tuple[int, dict]:
        with self.lock:
            cm = self.osdmap.crush.map
            return 0, {
                "buckets": [[b.name, b.type_name,
                             [(i, w) for i, w in zip(b.items, b.weights)]]
                            for b in cm.buckets.values()],
                "osds": [[o.id, "up" if o.up else "down",
                          "in" if o.in_ else "out"]
                         for o in self.osdmap.osds.values()],
            }

"""Monitor quorum: rank-based election + Paxos-replicated state.

Re-expresses the reference's mon consensus stack at the fidelity the
control plane needs:

- ElectionLogic (reference src/mon/ElectionLogic.cc, CLASSIC strategy):
  lowest reachable rank wins.  A candidate proposes an odd election
  epoch; peers of higher rank defer (ack), peers of lower rank counter-
  propose.  A majority of acks (counting self) makes the candidate
  leader; victory bumps to an even epoch and fixes the quorum.
- Paxos (reference src/mon/Paxos.cc): the leader owns a proposal number
  keyed to the election epoch, recovers peer state on victory
  (collect/last, Paxos.cc:401), then drives begin/accept/commit rounds
  for each state mutation.  Peons grant the leader a lease on commit;
  lease expiry at a peon triggers a new election (Paxos.cc:1073 lease
  machinery).

Idiomatic shifts from the reference: values are whole-map JSON snapshots
rather than transaction deltas (recovery becomes "adopt the highest
committed value" instead of log catch-up — the map is small; the
reference's incremental store matters at 100k-osd scale, not here), and
the many PaxosService instances collapse into one replicated value (the
OSDMap is the only service this control plane runs).

The protocol classes are transport-free: the Monitor injects `send(rank,
**fields)` and commit/roles callbacks, so the machines are unit-testable
without sockets.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class ElectionLogic:
    """Lowest-rank-wins election over n ranked monitors."""

    def __init__(self, rank: int, n_mons: int,
                 send: Callable, on_win: Callable[[int, list[int]], None],
                 on_defeat: Callable[[int, int, list[int]], None],
                 election_timeout: float = 0.8,
                 declare_delay: float = 0.25):
        self.rank = rank
        self.n = n_mons
        self.send = send                  # send(peer_rank, **fields)
        self.on_win = on_win              # (epoch, quorum)
        self.on_defeat = on_defeat        # (leader, epoch, quorum)
        self.election_timeout = election_timeout
        # grace after reaching majority so slower peers make the quorum
        # (reference waits the full election timeout before declaring)
        self.declare_delay = declare_delay
        self.epoch = 1                    # odd = electing, even = settled
        self.electing = False
        self.acks: set[int] = set()
        self._start_stamp = 0.0
        self._defer_stamp = 0.0           # when we last acked a peer
        self.lock = threading.RLock()

    def recently_deferred(self) -> bool:
        """True while we expect the peer we acked to declare victory;
        re-proposing during this window would livelock the election."""
        return time.monotonic() - self._defer_stamp < \
            self.election_timeout

    def majority(self) -> int:
        return self.n // 2 + 1

    def start(self) -> None:
        """Call an election (reference ElectionLogic::start)."""
        with self.lock:
            if self.epoch % 2 == 0:
                self.epoch += 1            # move to electing (odd)
            self.electing = True
            self.acks = {self.rank}
            self._start_stamp = time.monotonic()
        for peer in range(self.n):
            if peer != self.rank:
                self.send(peer, op="propose", epoch=self.epoch)
        self._check_win()

    def _check_win(self) -> None:
        with self.lock:
            if not self.electing or len(self.acks) < self.majority():
                return
            # full house declares at once; a bare majority waits the
            # declare grace so stragglers still join the quorum
            if len(self.acks) < self.n and \
                    time.monotonic() - self._start_stamp < \
                    self.declare_delay:
                return
            self.electing = False
            self.epoch += 1                # settled (even)
            quorum = sorted(self.acks)
            epoch = self.epoch
        # victory goes to EVERY peer, not just the quorum: a late
        # deferrer outside the quorum must still learn the outcome
        for peer in range(self.n):
            if peer != self.rank:
                self.send(peer, op="victory", epoch=epoch, quorum=quorum)
        self.on_win(epoch, quorum)

    def handle(self, from_rank: int, op: str, epoch: int,
               quorum: list[int] | None = None) -> None:
        if op == "propose":
            with self.lock:
                if epoch > self.epoch:
                    self.epoch = epoch if epoch % 2 == 1 else epoch + 1
            if from_rank < self.rank:
                # lower rank outranks us: defer (ack) and stand down
                with self.lock:
                    self.electing = False
                    self._defer_stamp = time.monotonic()
                self.send(from_rank, op="ack", epoch=epoch)
            else:
                # we outrank the proposer: counter-propose
                self.start()
        elif op == "ack":
            with self.lock:
                if not self.electing or epoch != self.epoch:
                    return
                self.acks.add(from_rank)
            self._check_win()
        elif op == "victory":
            with self.lock:
                if epoch < self.epoch:
                    return   # stale victory from an older election
                self.electing = False
                self.epoch = max(self.epoch, epoch)
            self.on_defeat(from_rank, epoch, quorum or [])

    def tick(self) -> None:
        """Declare after the grace, or retry a stalled election (peers
        down when we proposed)."""
        with self.lock:
            if not self.electing:
                return
            elapsed = time.monotonic() - self._start_stamp
            have_majority = len(self.acks) >= self.majority()
        if have_majority and elapsed >= self.declare_delay:
            self._check_win()
        elif elapsed > self.election_timeout:
            self.start()


class Paxos:
    """Single-value-pipeline Paxos over the elected quorum.

    The leader recovers with collect/last, then serializes begin/
    accept/commit rounds.  Values are dicts carrying a monotonically
    increasing integer under "epoch" (the OSDMap epoch doubles as the
    paxos version, like the reference's PaxosService version tracking).
    """

    LEASE_INTERVAL = 0.4      # leader re-grants at half this
    ACCEPT_TIMEOUT = 2.0
    COLLECT_TIMEOUT = 1.0

    def __init__(self, rank: int, n_mons: int, send: Callable,
                 on_commit: Callable[[dict], None],
                 get_committed: Callable[[], dict],
                 on_quorum_loss: Callable[[], None],
                 store=None):
        self.rank = rank
        self.n = n_mons
        self.send = send
        self.on_commit = on_commit          # apply a committed value
        self.get_committed = get_committed  # current committed value
        self.on_quorum_loss = on_quorum_loss
        # MonitorStore (mon/store.py): protocol state a restart must
        # not forget — the promise fences stale proposers across
        # restarts, and an accepted-uncommitted value must survive to
        # be surfaced to the next leader's collect
        self.store = store
        self.lock = threading.RLock()
        self.role = "electing"              # electing | leader | peon
        self.leader = -1
        self.quorum: list[int] = []
        self.pn = 0                         # proposal number (leader)
        self.promised = 0                   # highest pn promised (peon)
        self.uncommitted: tuple | None = None   # (pn, value)
        if store is not None:
            self.promised = store.load_promised()
            self.uncommitted = store.load_uncommitted()
        self.lease_expire = 0.0             # peon-side lease
        self.lease_acks: dict[int, float] = {}   # leader-side liveness
        self._round = None                  # in-flight round state
        self.proposal_lock = threading.Lock()  # one proposal at a time

    def majority(self) -> int:
        return self.n // 2 + 1

    # -- role transitions ---------------------------------------------------

    def win(self, election_epoch: int, quorum: list[int]) -> None:
        """We are leader: recover peer state (reference collect phase,
        Paxos.cc:401) before accepting proposals."""
        with self.lock:
            self.role = "leader"
            self.leader = self.rank
            self.quorum = quorum
            self.pn = (election_epoch << 16) | self.rank
            now = time.monotonic()
            self.lease_acks = {p: now for p in range(self.n)
                               if p != self.rank}
            self._collect = {
                "acks": {self.rank},
                "best": (self.get_committed(), None),   # (committed, unc)
                "event": threading.Event(),
            }
            best_unc = self.uncommitted
            if best_unc is not None:
                self._collect["best"] = (self.get_committed(), best_unc)
        # collect from every peer, not just the election quorum: a mon
        # that missed the election window still holds committed state
        # worth recovering (and stays synced as a follower)
        for peer in range(self.n):
            if peer != self.rank:
                self.send(peer, op="collect", pn=self.pn)
        self._finish_collect_when_ready()

    def _finish_collect_when_ready(self, wait: bool = True) -> None:
        col = self._collect
        if len(col["acks"]) >= self.majority():
            col["event"].set()
        if wait and not col["event"].wait(self.COLLECT_TIMEOUT) and \
                len(col["acks"]) < self.majority():
            # A leader that cannot hear a majority's state MUST NOT
            # serve: it could resurrect a stale map over a committed
            # one.  Abdicate and go back to the polls.
            with self.lock:
                self.role = "electing"
            self.on_quorum_loss()
            return
        committed, unc = col["best"]
        mine = self.get_committed()
        if committed.get("epoch", 0) > mine.get("epoch", 0):
            self.on_commit(committed)
        if unc is not None and \
                unc[1].get("epoch", 0) > \
                self.get_committed().get("epoch", 0):
            # finish the round a dead leader started
            self.propose(unc[1])

    def defeat(self, leader: int, epoch: int, quorum: list[int]) -> None:
        with self.lock:
            self.role = "peon"
            self.leader = leader
            self.quorum = quorum
            self.lease_expire = time.monotonic() + 3 * self.LEASE_INTERVAL

    # -- leader: propose ----------------------------------------------------

    def propose(self, value: dict) -> bool:
        """Replicate one value; True when a majority accepted and the
        commit went out (reference begin/accept/commit,
        Paxos.cc:692-903)."""
        if self.role != "leader":
            return False
        with self.proposal_lock:
            if self.role != "leader":
                return False
            rnd = {"acks": {self.rank}, "event": threading.Event(),
                   "pn": self.pn, "version": value.get("epoch", 0)}
            with self.lock:
                self._round = rnd
                self.uncommitted = (self.pn, value)
                if self.store is not None:
                    # survives a leader crash mid-round; cleared
                    # atomically when the commit lands (save_committed)
                    self.store.save_uncommitted(self.pn, value)
            for peer in range(self.n):
                if peer != self.rank:
                    self.send(peer, op="begin", pn=self.pn, value=value)
            if len(rnd["acks"]) >= self.majority():
                rnd["event"].set()
            ok = rnd["event"].wait(self.ACCEPT_TIMEOUT) and \
                len(rnd["acks"]) >= self.majority()
            with self.lock:
                self._round = None
                self.uncommitted = None
            if not ok:
                self.on_quorum_loss()
                return False
            for peer in range(self.n):
                if peer != self.rank:
                    self.send(peer, op="commit", pn=self.pn, value=value)
            self.on_commit(value)
            return True

    def grant_lease(self) -> None:
        if self.role != "leader":
            return
        # the lease advertises the committed version: a peon that
        # rejoined after a partition detects staleness and requests
        # catch-up instead of serving old state under a fresh lease
        epoch = self.get_committed().get("epoch", 0)
        for peer in range(self.n):
            if peer != self.rank:
                self.send(peer, op="lease", epoch=epoch)

    # -- message handling ---------------------------------------------------

    def handle(self, from_rank: int, op: str, pn: int = 0,
               value: dict | None = None,
               committed: dict | None = None,
               uncommitted: list | None = None,
               epoch: int = 0) -> None:
        if op == "collect":
            with self.lock:
                if pn > self.promised:
                    self.promised = pn
                    if self.store is not None:
                        self.store.save_promised(pn)
                unc = list(self.uncommitted) if self.uncommitted else None
            self.send(from_rank, op="last", pn=pn,
                      committed=self.get_committed(), uncommitted=unc)
        elif op == "last":
            with self.lock:
                col = getattr(self, "_collect", None)
                if col is None:
                    return
                col["acks"].add(from_rank)
                best_c, best_u = col["best"]
                if committed and committed.get("epoch", 0) > \
                        best_c.get("epoch", 0):
                    best_c = committed
                if uncommitted and (
                        best_u is None or
                        (uncommitted[1].get("epoch", 0), uncommitted[0])
                        > (best_u[1].get("epoch", 0), best_u[0])):
                    # tie-break equal map epochs by proposal number:
                    # the majority-accepted value carries the higher pn
                    best_u = (uncommitted[0], uncommitted[1])
                col["best"] = (best_c, best_u)
                if len(col["acks"]) >= self.majority():
                    col["event"].set()
        elif op == "begin":
            with self.lock:
                if pn < self.promised or self.role != "peon":
                    return          # stale proposer; ignore
                self.promised = pn
                self.uncommitted = (pn, value)
                if self.store is not None:
                    # accept is a durability promise: the value must
                    # survive our restart until committed or superseded
                    self.store.save_promised(pn)
                    self.store.save_uncommitted(pn, value)
                self.lease_expire = time.monotonic() + \
                    3 * self.LEASE_INTERVAL
            self.send(from_rank, op="accept", pn=pn)
        elif op == "accept":
            with self.lock:
                rnd = self._round
                if rnd is None or pn != rnd["pn"]:
                    return
                rnd["acks"].add(from_rank)
                if len(rnd["acks"]) >= self.majority():
                    rnd["event"].set()
        elif op == "commit":
            with self.lock:
                # a stale commit (catchup reply racing a newer begin)
                # must not clear a NEWER durable accepted value: that
                # value may already be chosen, and erasing it here
                # could roll back a client-acked round on leader crash
                keep = (self.uncommitted is not None and value and
                        self.uncommitted[1].get("epoch", 0) >
                        value.get("epoch", 0))
                if not keep:
                    self.uncommitted = None
                    if self.store is not None:
                        self.store.clear_uncommitted()
                self.lease_expire = time.monotonic() + \
                    3 * self.LEASE_INTERVAL
            if value and value.get("epoch", 0) > \
                    self.get_committed().get("epoch", 0):
                self.on_commit(value)
        elif op == "lease":
            with self.lock:
                # only OUR leader may extend the lease: a stale leader
                # on the wrong side of a partition must not keep its
                # minority serving old maps
                if self.role != "peon" or from_rank != self.leader:
                    return
                self.lease_expire = time.monotonic() + \
                    3 * self.LEASE_INTERVAL
                stale = epoch > self.get_committed().get("epoch", 0)
            self.send(from_rank, op="lease_ack")
            if stale:
                # we missed commits while partitioned: pull the value
                # (reference Paxos peon sync on lease/commit gap)
                self.send(from_rank, op="catchup")
        elif op == "catchup":
            with self.lock:
                if self.role != "leader":
                    return
                value = self.get_committed()
                pn = self.pn
            self.send(from_rank, op="commit", pn=pn, value=value)
        elif op == "lease_ack":
            with self.lock:
                if self.role == "leader":
                    self.lease_acks[from_rank] = time.monotonic()

    # -- periodic -----------------------------------------------------------

    def lease_expired(self) -> bool:
        with self.lock:
            return (self.role == "peon" and
                    time.monotonic() > self.lease_expire)

    def quorum_alive(self) -> bool:
        """Leader-side: do the peers' lease acks still witness a
        majority?  A leader partitioned into a minority must stand down
        rather than serve stale reads (reference Paxos lease_ack +
        Monitor quorum health)."""
        with self.lock:
            if self.role != "leader":
                return True
            if self.n == 1:
                return True
            cutoff = time.monotonic() - 3 * self.LEASE_INTERVAL
            live = 1 + sum(1 for t in self.lease_acks.values()
                           if t > cutoff)
            return live >= self.majority()

"""MonitorStore: durable backing for the monitor's replicated state.

Fills the MonitorDBStore role (reference src/mon/MonitorDBStore.h:37 —
every Paxos transaction is applied through one KV store so a restarted
monitor comes back with full state: maps, auth entities, config, pool
and EC-profile definitions).  A data dir is backed by the LSM engine
(store/kv_lsm.LsmDB, through store/kv.open_kv) that FileStore and
BlueStore ride, in the same on-disk format as ceph_tpu's, so a restarted
monitor comes back with its maps, profiles and pools; with no data dir
it is a MemDB, as every in-memory cluster runs.

Persisted keys:
  paxos:committed    — the committed multi-service value (JSON)
  paxos:promised     — highest proposal number promised (peon side)
  paxos:uncommitted  — an accepted-but-uncommitted round [pn, value]
                       (a restarted peon must still surface it to the
                       next leader's collect phase, or an acked commit
                       could be lost — reference Paxos.cc stashing
                       uncommitted values in the store)
"""

from __future__ import annotations

import json

from ..store.kv import MemDB, WriteBatch, open_kv

K_COMMITTED = b"paxos:committed"
K_PROMISED = b"paxos:promised"
K_UNCOMMITTED = b"paxos:uncommitted"


class MonitorStore:
    def __init__(self, path: str | None = None):
        self.db = open_kv(path)

    # -- committed value ----------------------------------------------------

    def load_committed(self) -> dict | None:
        raw = self.db.get(K_COMMITTED)
        return json.loads(raw.decode()) if raw is not None else None

    def save_committed(self, value: dict) -> None:
        # one atomic batch: adopting a commit also retires any
        # uncommitted round it supersedes
        b = WriteBatch()
        b.set(K_COMMITTED, json.dumps(value).encode())
        b.rm(K_UNCOMMITTED)
        self.db.submit(b)

    # -- paxos protocol state ----------------------------------------------

    def load_promised(self) -> int:
        raw = self.db.get(K_PROMISED)
        return int(raw.decode()) if raw is not None else 0

    def save_promised(self, pn: int) -> None:
        self.db.set(K_PROMISED, str(pn).encode())

    def load_uncommitted(self) -> tuple[int, dict] | None:
        raw = self.db.get(K_UNCOMMITTED)
        if raw is None:
            return None
        pn, value = json.loads(raw.decode())
        return int(pn), value

    def save_uncommitted(self, pn: int, value: dict) -> None:
        self.db.set(K_UNCOMMITTED, json.dumps([pn, value]).encode())

    def clear_uncommitted(self) -> None:
        self.db.rm(K_UNCOMMITTED)

    def close(self) -> None:
        self.db.close()

"""ReplicatedBackend: primary-copy replication.

Re-expresses reference src/osd/ReplicatedBackend.{h,cc}: the primary
applies the full transaction locally and ships it whole to each replica
(MOSDRepOp role — carried here by the same wire transaction envelope the
EC path uses), acking the client when all commit.  No RMW, no shards:
each replica holds the complete object.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from ..store.object_store import Transaction
from .ec_transaction import PGTransaction
from .pg_log import LogEntry, LogOp, PGLog
from .types import eversion_t, ghobject_t, hobject_t, NO_SHARD


class ReplicaBackend:
    """Transport seam to the replica set (primary's view); replica index
    0 is the primary itself."""

    n_replicas: int

    def rep_write(self, replica: int, txn: Transaction,
                  on_commit: Callable[[int], None]) -> None:
        raise NotImplementedError

    def local_read(self, oid: hobject_t, off: int,
                   length: int | None) -> np.ndarray:
        raise NotImplementedError

    def local_stat(self, oid: hobject_t) -> int | None:
        raise NotImplementedError


class LocalReplicaBackend(ReplicaBackend):
    """All replicas in one store (tests / single-host)."""

    def __init__(self, store, pgid, n_replicas: int):
        from .types import spg_t
        self.store = store
        self.n_replicas = n_replicas
        self.cids = {r: spg_t(pgid, NO_SHARD) if r == 0
                     else spg_t(pgid, -(r + 1)) for r in range(n_replicas)}
        for cid in self.cids.values():
            store.create_collection(cid)

    def rep_write(self, replica, txn, on_commit):
        self.store.queue_transactions(self.cids[replica], [txn])
        on_commit(replica)

    def local_read(self, oid, off, length):
        try:
            return self.store.read(self.cids[0],
                                   ghobject_t(oid, shard=NO_SHARD),
                                   off, length)
        except KeyError:
            return np.empty(0, dtype=np.uint8)

    def local_stat(self, oid):
        try:
            return self.store.stat(self.cids[0],
                                   ghobject_t(oid, shard=NO_SHARD))
        except KeyError:
            return None


class ReplicatedBackend:
    def __init__(self, replicas: ReplicaBackend, log: PGLog | None = None):
        self.replicas = replicas
        self.log = log or PGLog()
        self.lock = threading.RLock()
        self.completed = 0

    @staticmethod
    def _whole_oid(oid: hobject_t) -> ghobject_t:
        return ghobject_t(oid, shard=NO_SHARD)

    def _to_store_txn(self, txn: PGTransaction,
                      version: eversion_t | None = None) -> Transaction:
        t = Transaction()
        for oid, op in txn.ops.items():
            goid = self._whole_oid(oid)
            if op.delete:
                t.remove(goid)
                if not (op.writes or op.attrs or op.omap_ops or
                        op.truncate_to is not None):
                    continue
                # mutations staged after the delete recreate the object
            for w in op.writes:
                t.write(goid, w.offset, w.data)
            if op.truncate_to is not None:
                t.truncate(goid, op.truncate_to)
            sets = {k: v for k, v in op.attrs.items() if v is not None}
            if version is not None:
                # per-object version stamp (the reference's
                # object_info_t user_version in attr "_"): recovery
                # compares these across holders to find the
                # authoritative copy — epoch-first ordering makes an
                # interim primary's acked writes beat a revived
                # ex-primary's stale data
                sets["_v"] = \
                    f"{version.epoch}.{version.version}".encode()
            if sets:
                t.setattrs(goid, sets)
            for k in (k for k, v in op.attrs.items() if v is None):
                t.rmattr(goid, k)
            if op.omap_ops:
                t.touch(goid)   # omap mutation creates the object
            for mop in op.omap_ops:
                if mop[0] == "set":
                    t.omap_setkeys(goid, mop[1])
                elif mop[0] == "rm":
                    t.omap_rmkeys(goid, mop[1])
                elif mop[0] == "clear":
                    t.omap_clear(goid)
                elif mop[0] == "header":
                    t.omap_setheader(goid, mop[1])
        return t

    def read(self, oid: hobject_t, off: int = 0,
             length: int | None = None) -> np.ndarray:
        return self.replicas.local_read(oid, off, length)

    def stat(self, oid: hobject_t) -> int | None:
        return self.replicas.local_stat(oid)

    def submit_transaction(self, txn: PGTransaction, version: eversion_t,
                           on_commit: Callable[[], None]) -> None:
        store_txn = self._to_store_txn(txn, version)
        with self.lock:
            for oid, op in txn.ops.items():
                self.log.add(LogEntry(
                    version, oid,
                    LogOp.DELETE if op.delete else LogOp.MODIFY))
        n = self.replicas.n_replicas
        pending = {"count": n}

        def _on_commit(replica: int) -> None:
            with self.lock:
                pending["count"] -= 1
                if pending["count"] == 0:
                    self.log.roll_forward_to(version)
                    self.completed += 1
                    on_commit()

        for r in range(n):
            self.replicas.rep_write(r, store_txn, _on_commit)

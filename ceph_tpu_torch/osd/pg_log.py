"""PG log: per-PG op journal for recovery, EC rollback, and peering.

Re-expresses reference src/osd/PGLog.{h,cc} at the fidelity the EC
pipeline needs: an ordered list of entries keyed by eversion, each
carrying enough rollback state to locally undo it (the reference's
design constraint that EC ops be locally rollbackable —
doc/dev/osd_internals/erasure_coding/ecbackend.rst:9-27: append records
the old size, delete keeps the old generation, setattr keeps prior
values), plus the can_rollback_to / rollforward bounds ECBackend
advances in try_finish_rmw (reference ECBackend.cc:2115-2134).

The log is REPLICATED: every ECSubWrite carries its entries (reference
ECSubWrite.log_entries, src/osd/ECMsgTypes.h:38) and each shard persists
them durably alongside the data — omap of a per-PG meta object, the
analog of the reference's pglog omap keys in the pg meta collection
(src/osd/PGLog.cc _write_log_and_missing) — so a new primary can collect
shard logs and select the authoritative one after failover (reference
PeeringState::calc_acting / GetLog).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum

from .types import eversion_t, ghobject_t, hobject_t

# Reserved per-PG metadata object carrying the shard's log (omap) and
# info (xattr).  Filtered out of object enumeration (MPGList, scrub).
PG_META_NAME = "__pg_meta__"
INFO_ATTR = "_info"


def meta_oid(pool: int, shard: int) -> ghobject_t:
    return ghobject_t(hobject_t(pool, PG_META_NAME), shard=shard)


class LogOp(Enum):
    MODIFY = "modify"
    DELETE = "delete"
    ERROR = "error"


@dataclass
class RollbackInfo:
    """What a shard must remember to undo this entry locally."""
    append_old_size: int | None = None          # logical size before
    old_attrs: dict[str, bytes | None] | None = None  # prior xattr values
    kept_generation: int | None = None          # delete renamed to this gen
    hinfo_old: bytes | None = None              # prior hinfo xattr
    old_chunk_size: int | None = None           # per-shard size before
    pure_append: bool = False                   # undo == truncate


@dataclass
class LogEntry:
    version: eversion_t
    oid: hobject_t
    op: LogOp = LogOp.MODIFY
    rollback: RollbackInfo = field(default_factory=RollbackInfo)


@dataclass
class pg_info_t:
    """Shard-resident PG summary (reference osd_types.h pg_info_t, the
    slice peering needs: last_update orders logs inside an interval,
    last_epoch_started fences out shards that missed an interval)."""
    last_update: eversion_t = field(default_factory=eversion_t)
    last_epoch_started: int = 0

    def to_json(self) -> dict:
        return {"lu": [self.last_update.epoch, self.last_update.version],
                "les": self.last_epoch_started}

    @classmethod
    def from_json(cls, j: dict) -> "pg_info_t":
        return cls(eversion_t(*j["lu"]), j["les"])


def entry_to_wire(e: LogEntry) -> list:
    rb = e.rollback
    return [e.version.epoch, e.version.version,
            [e.oid.pool, e.oid.name, e.oid.key, e.oid.snap, e.oid.hash],
            e.op.value, rb.append_old_size, rb.old_chunk_size,
            rb.pure_append,
            rb.hinfo_old.hex() if rb.hinfo_old is not None else None,
            rb.kept_generation]


def entry_from_wire(w: list) -> LogEntry:
    return LogEntry(
        eversion_t(w[0], w[1]), hobject_t(*w[2]), LogOp(w[3]),
        RollbackInfo(append_old_size=w[4], old_chunk_size=w[5],
                     pure_append=w[6],
                     hinfo_old=bytes.fromhex(w[7]) if w[7] else None,
                     kept_generation=w[8] if len(w) > 8 else None))


def _omap_key(e: LogEntry) -> bytes:
    return (f"{e.version.epoch:010d}.{e.version.version:010d}."
            f"{e.oid.name}").encode()


class PGLog:
    def __init__(self) -> None:
        self.entries: list[LogEntry] = []
        self.head = eversion_t()            # newest logged
        self.tail = eversion_t()            # oldest kept
        self.can_rollback_to = eversion_t() # entries after this are undoable
        self.rollforward_to = eversion_t()  # entries before this are durable

    def add(self, entry: LogEntry) -> None:
        # >= not >: one txn's objects share the op version (reference
        # keeps one entry per object too, pg_log_entry_t per hobject)
        assert entry.version >= self.head, (entry.version, self.head)
        self.entries.append(entry)
        self.head = entry.version

    def roll_forward_to(self, v: eversion_t) -> list[LogEntry]:
        """Mark entries <= v irrevocable; returns the newly-stable ones
        (whose rollback state may be discarded / old gens trimmed)."""
        newly = [e for e in self.entries
                 if self.rollforward_to < e.version <= v]
        if v > self.rollforward_to:
            self.rollforward_to = v
        if v > self.can_rollback_to:
            self.can_rollback_to = v
        return newly

    def rollback_to(self, v: eversion_t) -> list[LogEntry]:
        """Drop entries newer than v; returns them newest-first so the
        caller can undo their store effects.  Only legal if v >=
        rollforward_to (can't undo what was rolled forward)."""
        assert v >= self.rollforward_to, (v, self.rollforward_to)
        undone = sorted((e for e in self.entries if e.version > v),
                        key=lambda e: e.version, reverse=True)
        self.entries = [e for e in self.entries if e.version <= v]
        self.head = v
        return undone

    def trim(self, to: eversion_t) -> None:
        """Discard entries <= to (reference log trimming)."""
        self.entries = [e for e in self.entries if e.version > to]
        if to > self.tail:
            self.tail = to


class ShardPGLog:
    """The shard-resident replicated log: entries + pg_info persisted in
    the store (omap + xattr of the per-PG meta object) in the SAME
    transaction as the data they describe, so the write and its log
    entry are atomic (reference ECBackend::handle_sub_write appends
    log_entries into the sub-write's ObjectStore::Transaction).

    Also owns shard-local rollback: a divergent shard undoes entries
    past the authoritative head using only its own persisted rollback
    state (the reference's "EC ops must be locally rollbackable"
    contract, ecbackend.rst:9-27).
    """

    def __init__(self, store, cid, shard: int):
        self.store = store
        self.cid = cid
        self.shard = shard
        self.moid = meta_oid(cid.pgid.pool, shard)
        self.log = PGLog()
        self.info = pg_info_t()
        self._load()

    def _load(self) -> None:
        try:
            raw = self.store.getattr(self.cid, self.moid, INFO_ATTR)
            self.info = pg_info_t.from_json(json.loads(raw.decode()))
        except KeyError:
            return
        try:
            omap = self.store.omap_get(self.cid, self.moid)
        except KeyError:
            omap = {}
        for key in sorted(omap):
            e = entry_from_wire(json.loads(omap[key].decode()))
            if e.version >= self.log.head:
                self.log.add(e)
        if self.log.entries:
            self.log.tail = self.log.entries[0].version

    def append_to_txn(self, txn, entries: list[LogEntry],
                      at_version: eversion_t) -> None:
        """Augment the shard data transaction with log persistence."""
        txn.touch(self.moid)
        if entries:
            txn.omap_setkeys(self.moid, {
                _omap_key(e): json.dumps(entry_to_wire(e)).encode()
                for e in entries})
        self.info.last_update = max(self.info.last_update, at_version)
        txn.setattr(self.moid, INFO_ATTR,
                    json.dumps(self.info.to_json()).encode())

    def record(self, entries: list[LogEntry], at_version: eversion_t
               ) -> None:
        """In-memory bookkeeping after the txn committed."""
        for e in entries:
            if e.version >= self.log.head:
                self.log.add(e)

    def advance_rollforward(self, rf: eversion_t) -> None:
        """Entries at or below rf are durable everywhere: their kept
        generations will never be rolled back to — reclaim them
        (reference trim_rollback_object on rollforward,
        ECBackend.cc try_finish_rmw)."""
        newly = self.log.roll_forward_to(rf)
        purge = [e for e in newly
                 if e.rollback.kept_generation is not None]
        if not purge:
            return
        txn = _txn()
        for e in purge:
            txn.remove(ghobject_t(e.oid, e.rollback.kept_generation,
                                  self.shard))
        self.store.queue_transactions(self.cid, [txn])

    def set_les(self, les: int) -> None:
        self.info.last_epoch_started = max(
            self.info.last_epoch_started, les)
        txn = _txn()
        txn.touch(self.moid)
        txn.setattr(self.moid, INFO_ATTR,
                    json.dumps(self.info.to_json()).encode())
        self.store.queue_transactions(self.cid, [txn])

    def adopt(self, entries: list[LogEntry], head: eversion_t,
              les: int) -> None:
        """Replace this shard's log with the authoritative one (a stale
        shard rejoining: its data is healed by recovery, its history by
        adoption — reference PGLog::merge_log for the divergent-free
        case)."""
        txn = _txn()
        txn.touch(self.moid)
        txn.omap_clear(self.moid)
        if entries:
            txn.omap_setkeys(self.moid, {
                _omap_key(e): json.dumps(entry_to_wire(e)).encode()
                for e in entries})
        self.log = PGLog()
        for e in sorted(entries, key=lambda e: e.version):
            self.log.add(e)
        self.info.last_update = head
        self.info.last_epoch_started = max(
            self.info.last_epoch_started, les)
        txn.setattr(self.moid, INFO_ATTR,
                    json.dumps(self.info.to_json()).encode())
        self.store.queue_transactions(self.cid, [txn])

    # -- PG split (reference PG::split_into / PGLog::split_out_child:
    #    the parent's log partitions by which child each entry's object
    #    rehashes into; the child inherits the parent's info bounds) ----

    def merge_split(self, entries: list[LogEntry], last_update: eversion_t,
                    les: int) -> None:
        """Adopt split-inherited entries WITHOUT clobbering anything
        this shard already logged (a child shard may have received
        backfill or even new writes before the local parent's split
        sweep ran — unlike `adopt`, which replaces).  The info bounds
        only ratchet up: inheriting the parent's last_update /
        last_epoch_started is what lets child peering fence out shards
        that never saw the parent's history."""
        existing = {_omap_key(e) for e in self.log.entries}
        add = sorted((e for e in entries
                      if _omap_key(e) not in existing),
                     key=lambda e: e.version)
        txn = _txn()
        txn.touch(self.moid)
        if add:
            txn.omap_setkeys(self.moid, {
                _omap_key(e): json.dumps(entry_to_wire(e)).encode()
                for e in add})
            merged = sorted(self.log.entries + add,
                            key=lambda e: e.version)
            newlog = PGLog()
            for e in merged:
                newlog.add(e)
            newlog.tail = self.log.tail
            newlog.can_rollback_to = self.log.can_rollback_to
            newlog.rollforward_to = self.log.rollforward_to
            self.log = newlog
        self.info.last_update = max(self.info.last_update, last_update)
        self.info.last_epoch_started = max(
            self.info.last_epoch_started, les)
        txn.setattr(self.moid, INFO_ATTR,
                    json.dumps(self.info.to_json()).encode())
        self.store.queue_transactions(self.cid, [txn])

    def fold_in(self, entries: list[LogEntry]) -> int:
        """PG-merge log union (the inverse of split_out): adopt a
        dying child's entries WITHOUT moving this shard's peering
        bounds.  Only entries at or below our own last_update union in
        (as recovery history); newer child entries are dropped here —
        their data travels as unlogged backfill instead — because a
        bound ratchet would be non-uniform across the parent's acting
        shards (each folds whichever children IT held) and the peering
        min-last_update rule would roll the ratcheted shards back,
        undoing folded writes as if they were divergent.  Returns the
        number of entries adopted."""
        fold = [e for e in entries
                if e.version <= self.info.last_update]
        if fold:
            self.merge_split(fold, self.info.last_update,
                             self.info.last_epoch_started)
        return len(fold)

    def split_out(self, names: set[str]) -> list[LogEntry]:
        """Drop (and return) the entries whose object moved to a child
        PG.  The parent's last_update is NOT lowered: it still bounds
        every entry the parent ever acked, and the peering min-rule
        needs all parent shards to agree on it."""
        moved = [e for e in self.log.entries if e.oid.name in names]
        if not moved:
            return []
        kept = [e for e in self.log.entries if e.oid.name not in names]
        txn = _txn()
        txn.touch(self.moid)
        txn.omap_rmkeys(self.moid, [_omap_key(e) for e in moved])
        newlog = PGLog()
        for e in kept:
            newlog.add(e)
        newlog.head = self.log.head
        newlog.tail = self.log.tail
        newlog.can_rollback_to = self.log.can_rollback_to
        newlog.rollforward_to = self.log.rollforward_to
        self.log = newlog
        self.store.queue_transactions(self.cid, [txn])
        return moved

    def rollback_to(self, v: eversion_t) -> list[hobject_t]:
        """Undo local entries newer than v.  Pure appends truncate back
        (and restore the prior hinfo xattr); overwrites/deletes restore
        the object generation snapshotted at write time; only legacy
        entries with neither are removed and reported, so the primary's
        recovery rebuilds them from the authoritative shards.
        Returns the oids needing such recovery."""
        from .ec_util import HINFO_KEY

        undone = [e for e in self.log.entries if e.version > v]
        undone.sort(key=lambda e: e.version, reverse=True)
        removed: list[hobject_t] = []
        txn = _txn()
        for e in undone:
            goid = ghobject_t(e.oid, shard=self.shard)
            rb = e.rollback
            has_gen = rb.kept_generation is not None and \
                self.store.exists(self.cid, ghobject_t(
                    e.oid, rb.kept_generation, self.shard))
            if has_gen:
                # the generation IS the pre-entry object (data + attrs)
                gen_goid = ghobject_t(e.oid, rb.kept_generation,
                                      self.shard)
                txn.remove(goid)
                txn.rename(gen_goid, goid)
            elif (e.op is LogOp.MODIFY and rb.pure_append
                    and rb.old_chunk_size is not None):
                if rb.old_chunk_size == 0 and rb.hinfo_old is None:
                    txn.remove(goid)
                else:
                    txn.truncate(goid, rb.old_chunk_size)
                    if rb.hinfo_old is not None:
                        txn.setattr(goid, HINFO_KEY, rb.hinfo_old)
                    else:
                        txn.rmattr(goid, HINFO_KEY)
            else:
                txn.remove(goid)
                if e.oid not in removed:
                    removed.append(e.oid)
            txn.omap_rmkeys(self.moid, [_omap_key(e)])
        self.log.rollforward_to = min(self.log.rollforward_to, v)
        self.log.rollback_to(v)
        self.info.last_update = v
        txn.touch(self.moid)
        txn.setattr(self.moid, INFO_ATTR,
                    json.dumps(self.info.to_json()).encode())
        self.store.queue_transactions(self.cid, [txn])
        return removed


def _txn():
    from ..store.object_store import Transaction
    return Transaction()

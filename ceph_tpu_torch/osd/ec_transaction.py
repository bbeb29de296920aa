"""EC write planning: logical object ops -> per-shard store transactions.

Re-expresses reference src/osd/ECTransaction.{h,cc}:

* `PGTransaction` — the logical mutation batch PrimaryLogPG produces
  (writes/truncates/deletes/attr sets per object).
* `WritePlan` (reference ECTransaction.h:26-32) — per object: which
  stripe-aligned extents must be pre-read (RMW) and which will be
  written.
* `generate_transactions` (reference ECTransaction.cc:97) — given the
  plan and the pre-read data, produce one ObjectStore Transaction per
  shard, encoding data via ECUtil (one batched codec call per object
  extent) and folding the per-shard crc32c into HashInfo
  (encode_and_write, reference ECTransaction.cc:25-60).

Planning is pure host logic, but all encodes in a
transaction batch are concatenated into a single codec launch by the
backend (see ec_backend.py) — the plan records extents, not per-stripe
work items.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..store.object_store import Transaction
from .ec_util import HINFO_KEY, HashInfo, StripeInfo
from .types import ghobject_t, hobject_t


# -- logical ops (PGTransaction) --------------------------------------------

@dataclass
class PGWrite:
    offset: int
    data: np.ndarray

    def __post_init__(self):
        self.data = np.asarray(self.data, dtype=np.uint8).ravel()

    @property
    def end(self) -> int:
        return self.offset + self.data.size


@dataclass
class PGObjectOp:
    """All mutations for one object within a PGTransaction."""
    writes: list[PGWrite] = field(default_factory=list)
    truncate_to: int | None = None
    delete: bool = False
    attrs: dict[str, bytes | None] = field(default_factory=dict)


class PGTransaction:
    def __init__(self) -> None:
        self.ops: dict[hobject_t, PGObjectOp] = {}

    def obj(self, oid: hobject_t) -> PGObjectOp:
        return self.ops.setdefault(oid, PGObjectOp())

    def write(self, oid: hobject_t, off: int, data) -> None:
        self.obj(oid).writes.append(PGWrite(off, data))

    def truncate(self, oid: hobject_t, size: int) -> None:
        self.obj(oid).truncate_to = size

    def delete(self, oid: hobject_t) -> None:
        # delete supersedes anything staged before it in this op
        # vector; mutations staged AFTER it recreate the object
        # (reference do_osd_ops applies the vector sequentially)
        op = self.obj(oid)
        op.writes.clear()
        op.attrs.clear()
        op.truncate_to = None
        op.delete = True

    def setattr(self, oid: hobject_t, name: str, value: bytes | None) -> None:
        self.obj(oid).attrs[name] = value


# -- plan --------------------------------------------------------------------

@dataclass
class Extent:
    off: int
    length: int

    @property
    def end(self) -> int:
        return self.off + self.length


@dataclass
class WritePlan:
    """reference ECTransaction.h:26: to_read/will_write per object."""
    to_read: dict[hobject_t, list[Extent]] = field(default_factory=dict)
    will_write: dict[hobject_t, list[Extent]] = field(default_factory=dict)
    hash_infos: dict[hobject_t, HashInfo] = field(default_factory=dict)
    sizes: dict[hobject_t, int] = field(default_factory=dict)


def _merge_extents(extents: list[Extent]) -> list[Extent]:
    out: list[Extent] = []
    for e in sorted(extents, key=lambda x: x.off):
        if out and e.off <= out[-1].end:
            out[-1] = Extent(out[-1].off,
                             max(out[-1].end, e.end) - out[-1].off)
        else:
            out.append(Extent(e.off, e.length))
    return out


def get_write_plan(sinfo: StripeInfo, txn: PGTransaction,
                   get_hinfo, get_size, reset_hinfo=None) -> WritePlan:
    """Round writes out to stripe bounds; extents not fully covered by
    the new data and inside the current object need an RMW pre-read
    (reference ECTransaction get_write_plan semantics exercised by
    src/test/osd/test_ec_transaction.cc:29-85).  `reset_hinfo(oid)`,
    when given, must swap a FRESH HashInfo into the caller's projected
    chain and return it (used for delete-then-recreate vectors)."""
    plan = WritePlan()
    for oid, op in txn.ops.items():
        size = get_size(oid)
        plan.sizes[oid] = size
        plan.hash_infos[oid] = get_hinfo(oid)
        if op.delete and not op.writes:
            continue
        if op.delete:
            # delete-then-recreate in one vector (reference do_osd_ops
            # evolves obs through the vector; the replicated backend's
            # _to_store_txn already recreates): the plan must see the
            # FRESH object — no RMW pre-reads of pre-delete bytes, size
            # 0, reset hinfo.  `reset_hinfo` swaps a NEW instance into
            # the caller's projected chain so this op and later queued
            # ops seed from the recreate, while earlier in-flight ops
            # keep folding onto the instance they already planned
            # against (mutating the shared one in place would corrupt
            # their crc chains).  Rollback still restores the old
            # object from the generation kept at commit time.
            size = 0
            plan.sizes[oid] = 0
            if reset_hinfo is not None:
                plan.hash_infos[oid] = reset_hinfo(oid)
            else:
                old = plan.hash_infos[oid]
                plan.hash_infos[oid] = HashInfo.make(
                    len(old.cumulative_shard_hashes))
        will, read = [], []
        for w in op.writes:
            start = sinfo.logical_to_prev_stripe_offset(w.offset)
            end = sinfo.logical_to_next_stripe_offset(w.end)
            will.append(Extent(start, end - start))
            # Head/tail partial stripes overlapping existing data -> read.
            if start < w.offset and start < size:
                read.append(Extent(start, sinfo.stripe_width))
            tail_start = sinfo.logical_to_prev_stripe_offset(w.end)
            if w.end < min(end, size) and tail_start >= start:
                read.append(Extent(tail_start, sinfo.stripe_width))
        plan.will_write[oid] = _merge_extents(will)
        reads = [e for e in _merge_extents(read) if e.off < size]
        if reads:
            plan.to_read[oid] = reads
    return plan


# -- generate ----------------------------------------------------------------

def shard_oid(oid: hobject_t, shard: int,
              generation: int | None = None) -> ghobject_t:
    from .types import NO_GEN
    return ghobject_t(oid, NO_GEN if generation is None else generation,
                      shard)


def generate_transactions(
    sinfo: StripeInfo,
    n_shards: int,
    plan: WritePlan,
    txn: PGTransaction,
    encoded: dict[tuple[hobject_t, int], np.ndarray],
    encoded_crcs: dict[tuple[hobject_t, int], list[int]] | None = None,
    gen: int | None = None,
    gen_oids: set[hobject_t] | None = None,
) -> tuple[dict[int, Transaction], dict[hobject_t, HashInfo]]:
    """Turn encoded extents + metadata ops into per-shard Transactions.

    `encoded` maps (oid, extent.off) -> (k+m, chunk_run) shard bytes —
    produced by the backend's batched codec launch.  `encoded_crcs`
    optionally carries cumulative shard crcs the fused CUDA kernel
    already produced for an extent (seeded with the prior hinfo state);
    when present for an appending extent the host crc pass is skipped
    entirely.  Returns per-shard transactions and the updated HashInfos
    (written as hinfo xattrs on every shard, reference
    ECTransaction.cc:25-60 encode_and_write).
    """
    encoded_crcs = encoded_crcs or {}
    gen_oids = gen_oids or set()
    txns = {s: Transaction() for s in range(n_shards)}
    new_hinfos: dict[hobject_t, HashInfo] = {}
    for oid, op in txn.ops.items():
        # Object generations (reference ecbackend.rst:9-27 "delete
        # keeps the old generation"): a mutation that cannot be undone
        # by truncation snapshots the shard object under the op's
        # generation id first, making EVERY entry locally rollbackable.
        keep_gen = gen is not None and oid in gen_oids
        if op.delete:
            for s in range(n_shards):
                if keep_gen:
                    txns[s].rename(shard_oid(oid, s),
                                   shard_oid(oid, s, generation=gen))
                else:
                    txns[s].remove(shard_oid(oid, s))
            if not op.writes:
                continue
            # delete-then-recreate: the writes below land on the fresh
            # (vacated) object name — no clone, the rename/remove above
            # already made the generation the rollback snapshot
        elif keep_gen:
            for s in range(n_shards):
                txns[s].clone(shard_oid(oid, s),
                              shard_oid(oid, s, generation=gen))
        hinfo = plan.hash_infos[oid]
        for ext in plan.will_write.get(oid, []):
            shards = encoded[(oid, ext.off)]
            chunk_off = sinfo.aligned_logical_offset_to_chunk_offset(ext.off)
            chunk_run = shards.shape[1]
            appending = chunk_off == hinfo.total_chunk_size
            if appending and (oid, ext.off) in encoded_crcs:
                hinfo.append_precomputed(chunk_off, chunk_run,
                                         encoded_crcs[(oid, ext.off)])
            elif appending:
                hinfo.append(chunk_off, shards)
            else:
                # overwrite inside the object: incremental crc is dead
                # even at unchanged size; the generation kept above
                # carries rollback, the shard chunk_crc carries integrity
                hinfo.invalidate(max(hinfo.total_chunk_size,
                                     chunk_off + chunk_run))
            for s in range(n_shards):
                txns[s].write(shard_oid(oid, s), chunk_off, shards[s])
        if op.truncate_to is not None:
            chunk_size = sinfo.logical_to_next_chunk_offset(op.truncate_to)
            hinfo.truncate(chunk_size)
            for s in range(n_shards):
                txns[s].truncate(shard_oid(oid, s), chunk_size)
        # logical (unpadded) object size, kept in the hinfo xattr
        # (reference: object_info_t.size)
        new_logical = hinfo.logical_size
        for w in op.writes:
            new_logical = max(new_logical, w.end)
        if op.truncate_to is not None:
            new_logical = op.truncate_to
        hinfo.logical_size = new_logical
        if op.attrs:
            sets = {k: v for k, v in op.attrs.items() if v is not None}
            dels = [k for k, v in op.attrs.items() if v is None]
            for s in range(n_shards):
                if sets:
                    txns[s].setattrs(shard_oid(oid, s), sets)
                for k in dels:
                    txns[s].rmattr(shard_oid(oid, s), k)
        # persist hinfo on every shard (xattr hinfo_key, ECUtil.h:101)
        raw = hinfo.encode()
        for s in range(n_shards):
            txns[s].setattr(shard_oid(oid, s), HINFO_KEY, raw)
        new_hinfos[oid] = hinfo
    return txns, new_hinfos

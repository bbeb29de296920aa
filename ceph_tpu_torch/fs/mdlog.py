"""MDLog: the MDS metadata journal.

Re-expresses reference src/mds/MDLog.h + journal/ at the granularity
this MDS needs: every multi-step namespace mutation writes an INTENT
event to a per-MDS log object BEFORE touching the directory objects,
and marks it done after.  A crashed MDS replays pending events on
restart, completing (redo semantics) whatever half-applied mutation it
died inside — without the log, a rename could leave the file linked in
both directories or neither.

The log object lives in the metadata pool and uses omap: one row per
event, keyed by zero-padded sequence number (the role of the
reference's journal segments in the metadata pool); completion removes
the row (the reference expires whole segments — row-per-event is the
honest equivalent at this scale).  Events record REDO data: applying
one twice must be idempotent, which each replay handler guarantees by
checking current state first.
"""

from __future__ import annotations

import json
import threading


def _log_oid(rank) -> str:
    return f"mds_log.{rank}"


class MDLog:
    def __init__(self, meta_ioctx, rank="0"):
        self.io = meta_ioctx
        self.rank = rank
        self._seq = 0
        # MDS handlers run concurrently (per-connection dispatch
        # threads); an unsynchronized counter would hand two intents
        # the same row, one silently overwriting the other
        self._seq_lock = threading.Lock()
        # resume the sequence past any pending entries
        pending = self.pending()
        if pending:
            self._seq = max(seq for seq, _ in pending)

    def append(self, event: dict) -> int:
        """Durably record an intent; returns its seq for mark_done."""
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        self.io.omap_set(_log_oid(self.rank), {
            f"{seq:016d}".encode():
                json.dumps(event, separators=(",", ":")).encode()})
        return seq

    def mark_done(self, seq: int) -> None:
        self.io.omap_rm_keys(_log_oid(self.rank),
                             [f"{seq:016d}".encode()])

    def pending(self) -> list[tuple[int, dict]]:
        """Events whose mutation may be half-applied, in log order."""
        from ..rados.client import RadosError
        try:
            kv = self.io.omap_get_vals(_log_oid(self.rank))
        except RadosError:
            return []
        return sorted((int(k.decode()), json.loads(v.decode()))
                      for k, v in kv.items())

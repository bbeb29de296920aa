"""SnapSet: per-object snapshot/clone bookkeeping.

Re-expresses the reference's SnapSet machinery (src/osd/osd_types.h
SnapSet, PrimaryLogPG::make_writeable, src/osd/PrimaryLogPG.cc) at the
fidelity self-managed snapshots need:

- Clients carry a SnapContext (seq + existing snap ids) on writes.
- The head object's SnapSet xattr records the newest seq it has seen
  and its clone list.  A write whose snapc.seq is newer than the
  recorded seq first CLONES the head to an object whose hobject.snap
  is the snapc seq (copy-on-write), then applies.
- A read at snap s resolves to the OLDEST clone with clone_snap >= s
  (that clone holds the content as of s); with no such clone the head
  serves (the object hasn't changed since s) — unless the object was
  born after s.
"""

from __future__ import annotations

import json

SS_KEY = "snapset"
# When a head is deleted under a SnapContext its SnapSet moves to a
# snapdir object (hobject.snap = SNAPDIR) so the clone history survives
# a later recreate (reference CEPH_SNAPDIR).
SNAPDIR = 1 << 62


class SnapSet:
    def __init__(self, seq: int = 0, clones: list[int] | None = None,
                 born: int = 0, prior_born: int = 0):
        self.seq = seq             # newest snap id this head has seen
        self.clones = clones or []  # clone snap ids, ascending
        self.born = born           # snap seq when the head was created
        # birth seq of the PREVIOUS incarnation (delete+recreate):
        # prior-incarnation clones never serve snaps older than it
        self.prior_born = prior_born

    def encode(self) -> bytes:
        return json.dumps({"seq": self.seq, "clones": self.clones,
                           "born": self.born,
                           "pborn": self.prior_born}).encode()

    @classmethod
    def decode(cls, raw: bytes | None) -> "SnapSet":
        if not raw:
            return cls()
        j = json.loads(raw.decode())
        return cls(j.get("seq", 0), list(j.get("clones", [])),
                   j.get("born", 0), j.get("pborn", 0))

    def needs_cow(self, snapc_seq: int) -> bool:
        return snapc_seq > self.seq

    def add_clone(self, snap_id: int) -> None:
        self.clones.append(snap_id)
        self.clones.sort()
        self.seq = max(self.seq, snap_id)

    def resolve(self, snap: int) -> int | None:
        """Which object serves a read at snap id `snap`?
        Returns the clone snap id, 0 for the head, or None when the
        object did not exist at that snap.

        A clone older than `born` belongs to a previous incarnation
        (the head was deleted and recreated; the clone history rode the
        snapdir): it still serves its snaps.  A clone newer than `born`
        only covers snaps after the (re)creation."""
        c = next((cs for cs in self.clones if cs >= snap), None)
        if c is not None:
            if c <= self.born:
                # prior-incarnation clone: still fenced by ITS birth
                return c if snap > self.prior_born else None
            return c if snap > self.born else None
        return 0 if snap > self.born else None

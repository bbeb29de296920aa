"""Core object/placement types.

Re-expresses the reference's osd_types (src/osd/osd_types.h): object and
placement-group identities, shard ids, eversion ordering, and the pool
type constants the backends switch on.
"""

from __future__ import annotations

from dataclasses import dataclass, field

NO_SHARD = -1
NO_GEN = 0xFFFFFFFFFFFFFFFF


@dataclass(frozen=True, order=True)
class hobject_t:
    """Hashed object id (reference src/common/hobject.h): name + key +
    snapshot + a placement hash that decides its PG."""
    pool: int = 0
    name: str = ""
    key: str = ""
    snap: int = 0
    hash: int = 0


@dataclass(frozen=True, order=True)
class ghobject_t:
    """Generational + sharded object id (reference hobject.h ghobject_t):
    what actually keys the ObjectStore.  EC keeps old generations for
    rollback (reference ecbackend.rst; generation bumped on overwrite)."""
    hobj: hobject_t = field(default_factory=hobject_t)
    generation: int = NO_GEN
    shard: int = NO_SHARD


@dataclass(frozen=True, order=True)
class pg_t:
    """Placement group id: pool + seed (reference osd_types.h pg_t)."""
    pool: int = 0
    seed: int = 0

    def __str__(self) -> str:
        return f"{self.pool}.{self.seed:x}"


@dataclass(frozen=True, order=True)
class spg_t:
    """Shard-addressed PG (reference osd_types.h spg_t): which shard of
    an EC PG a message/store-collection refers to."""
    pgid: pg_t = field(default_factory=pg_t)
    shard: int = NO_SHARD

    def __str__(self) -> str:
        return f"{self.pgid}s{self.shard}" if self.shard != NO_SHARD \
            else str(self.pgid)


@dataclass(frozen=True, order=True)
class eversion_t:
    """Epoch+version log position (reference osd_types.h eversion_t)."""
    epoch: int = 0
    version: int = 0

    def __str__(self) -> str:
        return f"{self.epoch}'{self.version}"

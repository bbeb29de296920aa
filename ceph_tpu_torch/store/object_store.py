"""ObjectStore contract + Transaction.

Re-expresses the reference's `ObjectStore`/`ObjectStore::Transaction`
(src/os/ObjectStore.h, src/os/Transaction.h): an ordered batch of
mutations applied atomically to one collection-set, with commit
callbacks.  The OSD's backends build Transactions and
`queue_transactions` them; the store decides durability.

Ops are a small closed set (the reference's Transaction::Op enum),
carried as dataclass records so stores replay them; EC restricts itself
to the rollbackable subset (append/remove-keeping-gen/setattr with
prior-value retention — reference
doc/dev/osd_internals/erasure_coding/ecbackend.rst:9-27).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np

from ..osd.types import ghobject_t, spg_t


# -- transaction ops ---------------------------------------------------------

@dataclass
class OpTouch:
    oid: ghobject_t


@dataclass
class OpWrite:
    oid: ghobject_t
    offset: int
    data: np.ndarray          # uint8

    def __post_init__(self):
        self.data = np.asarray(self.data, dtype=np.uint8).ravel()


@dataclass
class OpZero:
    oid: ghobject_t
    offset: int
    length: int


@dataclass
class OpTruncate:
    oid: ghobject_t
    size: int


@dataclass
class OpRemove:
    oid: ghobject_t


@dataclass
class OpSetAttrs:
    oid: ghobject_t
    attrs: dict[str, bytes]


@dataclass
class OpRmAttr:
    oid: ghobject_t
    name: str


@dataclass
class OpClone:
    src: ghobject_t
    dst: ghobject_t


@dataclass
class OpRename:
    src: ghobject_t
    dst: ghobject_t


@dataclass
class OpOmapSet:
    oid: ghobject_t
    kv: dict[bytes, bytes]


@dataclass
class OpOmapRmKeys:
    oid: ghobject_t
    keys: list[bytes]


@dataclass
class OpOmapClear:
    oid: ghobject_t


@dataclass
class OpOmapSetHeader:
    oid: ghobject_t
    data: bytes


class Transaction:
    """Ordered op batch + commit callbacks (reference Transaction.h)."""

    def __init__(self) -> None:
        self.ops: list = []
        self.on_commit: list[Callable[[], None]] = []

    def empty(self) -> bool:
        return not self.ops

    def append(self, other: "Transaction") -> None:
        self.ops.extend(other.ops)
        self.on_commit.extend(other.on_commit)

    # op constructors
    def touch(self, oid):            self.ops.append(OpTouch(oid))
    def write(self, oid, off, data): self.ops.append(OpWrite(oid, off, data))
    def zero(self, oid, off, ln):    self.ops.append(OpZero(oid, off, ln))
    def truncate(self, oid, size):   self.ops.append(OpTruncate(oid, size))
    def remove(self, oid):           self.ops.append(OpRemove(oid))
    def setattrs(self, oid, attrs):  self.ops.append(OpSetAttrs(oid, dict(attrs)))
    def setattr(self, oid, k, v):    self.ops.append(OpSetAttrs(oid, {k: bytes(v)}))
    def rmattr(self, oid, k):        self.ops.append(OpRmAttr(oid, k))
    def clone(self, src, dst):       self.ops.append(OpClone(src, dst))
    def rename(self, src, dst):      self.ops.append(OpRename(src, dst))
    def omap_setkeys(self, oid, kv): self.ops.append(OpOmapSet(oid, dict(kv)))
    def omap_rmkeys(self, oid, ks):  self.ops.append(OpOmapRmKeys(oid, list(ks)))
    def omap_clear(self, oid):       self.ops.append(OpOmapClear(oid))
    def omap_setheader(self, oid, d): self.ops.append(OpOmapSetHeader(oid, bytes(d)))

    def register_on_commit(self, cb: Callable[[], None]) -> None:
        self.on_commit.append(cb)


# -- store contract ----------------------------------------------------------

class ObjectStore(abc.ABC):
    """Reference src/os/ObjectStore.h: collections of objects with data,
    xattrs and omap; transactional writes; enumerable for scrub."""

    @abc.abstractmethod
    def mount(self) -> None: ...

    @abc.abstractmethod
    def umount(self) -> None: ...

    @abc.abstractmethod
    def create_collection(self, cid: spg_t) -> None: ...

    @abc.abstractmethod
    def remove_collection(self, cid: spg_t) -> None: ...

    @abc.abstractmethod
    def list_collections(self) -> list[spg_t]: ...

    @abc.abstractmethod
    def collection_exists(self, cid: spg_t) -> bool: ...

    @abc.abstractmethod
    def queue_transactions(self, cid: spg_t,
                           txns: Iterable[Transaction]) -> None:
        """Apply transactions atomically-per-txn and fire on_commit.
        (reference ObjectStore::queue_transactions, the call ECBackend
        makes at src/osd/ECBackend.cc:983)"""

    # -- reads --------------------------------------------------------------

    @abc.abstractmethod
    def read(self, cid: spg_t, oid: ghobject_t, offset: int = 0,
             length: int | None = None) -> np.ndarray: ...

    @abc.abstractmethod
    def stat(self, cid: spg_t, oid: ghobject_t) -> int:
        """Object size; raises KeyError if absent."""

    @abc.abstractmethod
    def exists(self, cid: spg_t, oid: ghobject_t) -> bool: ...

    @abc.abstractmethod
    def getattr(self, cid: spg_t, oid: ghobject_t, name: str) -> bytes: ...

    @abc.abstractmethod
    def getattrs(self, cid: spg_t, oid: ghobject_t) -> dict[str, bytes]: ...

    @abc.abstractmethod
    def omap_get(self, cid: spg_t, oid: ghobject_t) -> dict[bytes, bytes]: ...

    def omap_get_header(self, cid: spg_t, oid: ghobject_t) -> bytes:
        """Omap header blob (reference ObjectStore omap_get_header);
        empty when never set."""
        return b""

    @abc.abstractmethod
    def list_objects(self, cid: spg_t) -> list[ghobject_t]: ...

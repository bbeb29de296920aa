"""Local object stores (reference src/os/)."""

from .object_store import ObjectStore, Transaction
from .mem_store import MemStore

# FileStore, BlueStore and the LSM engine under them are not ported yet.
NOT_PORTED = ("the persistent stores (filestore, bluestore, the LSM kv "
              "engine) are not ported to ceph_tpu_torch yet; use "
              "memstore")


def create_store(kind: str, path: str | None = None) -> ObjectStore:
    """reference ObjectStore::create (src/ceph_osd.cc:286): pick a
    backend by name.  Only `memstore` is ported; a persistent kind
    raises."""
    if kind == "memstore":
        return MemStore()
    if kind == "filestore" or kind.startswith("bluestore"):
        raise NotImplementedError(f"objectstore {kind!r}: {NOT_PORTED}")
    raise ValueError(f"unknown objectstore {kind!r}")


__all__ = ["ObjectStore", "Transaction", "MemStore", "create_store"]

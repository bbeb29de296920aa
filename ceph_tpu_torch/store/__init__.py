"""Local object stores (reference src/os/)."""

from .object_store import ObjectStore, Transaction
from .mem_store import MemStore


def create_store(kind: str, path: str | None = None) -> ObjectStore:
    """reference ObjectStore::create (src/ceph_osd.cc:286): pick a
    backend by name."""
    if kind == "memstore":
        return MemStore()
    if kind == "filestore":
        from .file_store import FileStore
        assert path, "filestore needs a path"
        return FileStore(path)
    if kind.startswith("bluestore"):
        from .blue_store import BlueStore
        assert path, "bluestore needs a path"
        # "bluestore" or "bluestore-<compressor>" (zlib/bz2/lzma)
        return BlueStore(path,
                         compression=kind.partition("-")[2] or None)
    raise ValueError(f"unknown objectstore {kind!r}")


__all__ = ["ObjectStore", "Transaction", "MemStore", "create_store"]

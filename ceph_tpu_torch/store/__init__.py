"""Local object stores (reference src/os/)."""

from .object_store import ObjectStore, Transaction
from .mem_store import MemStore

__all__ = ["ObjectStore", "Transaction", "MemStore"]

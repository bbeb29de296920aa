"""librados-like public client API (reference src/librados/)."""

from .client import IoCtx, RadosClient

__all__ = ["RadosClient", "IoCtx"]

"""Monitor: cluster-map authority (reference src/mon/)."""

from .monitor import Monitor

__all__ = ["Monitor"]

"""Client-side op engine (reference src/osdc/)."""

from .objecter import Objecter

__all__ = ["Objecter"]

"""Erasure-code subsystem: interface, GF(2^8) matrices, registry, plugins."""

from .interface import ErasureCodeError, ErasureCodeInterface, Profile
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry

__all__ = ["ErasureCodeError", "ErasureCodeInterface", "Profile",
           "ErasureCodePlugin", "ErasureCodePluginRegistry"]

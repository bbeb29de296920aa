"""CRUSH: deterministic pseudo-random placement (reference src/crush/)."""

from .map import CrushMap, Rule, Step
from .wrapper import CrushWrapper

__all__ = ["CrushMap", "CrushWrapper", "Rule", "Step"]

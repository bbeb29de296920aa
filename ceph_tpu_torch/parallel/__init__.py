"""Device parallelism for the EC data plane: the CLAY repair lowering
(`ClayRepairPlan`) on one card."""

from .mesh import ClayRepairPlan

__all__ = ["ClayRepairPlan"]

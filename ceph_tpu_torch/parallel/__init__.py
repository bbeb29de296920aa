"""Device parallelism for the EC data plane: the CLAY repair lowering
(`ClayRepairPlan`) on one card and the per-host launch queue
(`ECLaunchQueue`) that coalesces many PGs' launches."""

from .launch_queue import ECLaunchQueue, LaunchQueueError
from .mesh import ClayRepairPlan

__all__ = ["ClayRepairPlan", "ECLaunchQueue", "LaunchQueueError"]

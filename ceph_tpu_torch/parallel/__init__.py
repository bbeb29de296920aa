"""Device parallelism for the EC data plane: the sharded stripe codec
over a device mesh (`make_mesh`, `DistributedStripeCodec`) and its
per-host broker (`MeshService`), the CLAY repair lowering
(`ClayRepairPlan`) and the per-host launch queue (`ECLaunchQueue`) that
coalesces many PGs' launches."""

from .launch_queue import ECLaunchQueue, LaunchQueueError
from .mesh import ClayRepairPlan, DistributedStripeCodec, make_mesh
from .service import MeshError, MeshService

__all__ = ["ClayRepairPlan", "DistributedStripeCodec", "ECLaunchQueue",
           "LaunchQueueError", "MeshError", "MeshService", "make_mesh"]

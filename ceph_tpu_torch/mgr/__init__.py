"""Manager (mgr): the module host for cluster-level services.

Re-expresses the reference's ceph-mgr (src/mgr/ + src/pybind/mgr/):
a daemon that subscribes to cluster maps and hosts pluggable python
modules behind a small MgrModule API.  Built-in modules:

- health: cluster health model (HEALTH_OK/WARN/ERR from down OSDs,
  degraded PGs, missing quorum) — the `ceph status` health role.
- balancer: evens the PG-per-OSD distribution by proposing pg_temp
  remaps (the upmap balancer role, reference pybind/mgr/balancer).
- pg_autoscaler: recommends pg_num per pool from utilization
  (advisory — pools here don't split PGs; reference
  pybind/mgr/pg_autoscaler biases the same math).
- prometheus: the metrics exporter (tools/metrics_exporter wraps it
  for standalone use).
"""

from .daemon import MgrDaemon, MgrModule

__all__ = ["MgrDaemon", "MgrModule"]

"""RGW-role object gateway: S3 API subset over librados.

Re-expresses the reference radosgw's load-bearing shape
(src/rgw/rgw_op.cc op surface, src/rgw/rgw_rados.cc layout,
src/cls/rgw/ bucket index): buckets with cls-maintained index objects,
object data in rados objects, an HTTP frontend speaking the S3 REST
dialect with AWS SigV4 authentication.
"""

from .store import RGWError, RGWStore
from .gateway import S3Gateway

__all__ = ["RGWStore", "RGWError", "S3Gateway"]

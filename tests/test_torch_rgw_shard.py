"""tests/test_rgw_shard.py replayed on the port: the hash-sharded bucket
index, merged listings across shards, online resharding (grow,
shrink, under concurrent PUTs, interrupted and resumed, autoscaled)
and the quota gate across stores."""

import pytest

from test_torch_cluster_foundations import (  # noqa: F401
    cases, port_singletons, ported, replay)

SHARD = ported("test_rgw_shard")
# the reference's own fixtures, on the port
cluster, st, listbkt = SHARD.cluster, SHARD.st, SHARD.listbkt


@pytest.mark.parametrize("case", cases(SHARD))
def test_rgw_shard_replay(case, request):
    replay(SHARD, case, request)

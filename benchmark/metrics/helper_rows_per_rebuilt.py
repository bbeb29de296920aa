"""helper_rows_per_rebuilt.<entry>: helper rows the layered LRC device
path's repairs read, a row they rebuilt
(ec/plugins/ec_lrc.local_repair_counts: helper_rows / rebuilt_rows, over
the run's set-up, warm-up and window alike, which all repair from the
same groups, so the ratio needs no reset).  3.0 for a single-chunk
repair of k=4 m=2 l=3 from its local group; 4 or more where a repair
reads k helpers.  Layer: codec entry.  Nothing to read where the
program has no such counter or it counted no repair."""


def read(ctx, name):
    try:
        from ceph_tpu_torch.ec.plugins import ec_lrc
    except ImportError:
        return None
    counts = getattr(ec_lrc, "local_repair_counts", None)
    if counts is None:
        return None
    got = counts()
    if not got.get("rebuilt_rows"):
        return None
    return got["helper_rows"] / got["rebuilt_rows"]

"""host_prep_us.<entry>: host microseconds a traced call spends in the
`prep` stage of its kernel launch (ops/bitsliced.launch_stages, summed
over the wrappers, over the window's traced calls): from the first line
of the program's entry to just before the C call — the codec's plan
lookup, the operand checks, the launch arithmetic and the outputs'
allocation.  The stages are clocked only under the profiler, so the
number holds the profiler's own cost per aten op and is above what the
untraced `dispatch_us` would give it.  Layer: codec entry.  Nothing to
read where no armed launch was counted (the CPU, no traced calls, a
program without the stages)."""


def read(ctx, name):
    from ceph_tpu_torch.ops import bitsliced as bs
    stages = getattr(bs, "launch_stages", None)
    calls = ctx.window.traced_calls
    if stages is None or not calls:
        return None
    got = stages().values()
    if not any(s["calls"] for s in got):
        return None
    return sum(s["prep_ns"] for s in got) / calls / 1e3

"""host_launch_us.<entry>: host microseconds a traced call spends in the
`launch` stage of its kernel launch (ops/bitsliced.launch_stages, summed
over the wrappers, over the window's traced calls): the kernel
library's load, the stream handle, the tensors' pointers and the C call
into the library up to its return-code check.  The stages are clocked
only under the profiler, so the number holds CUPTI's cost per launch
and is above what the untraced `dispatch_us` would give it.  Layer:
codec entry.  Nothing to read where no armed launch was counted (the
CPU, no traced calls, a program without the stages)."""


def read(ctx, name):
    from ceph_tpu_torch.ops import bitsliced as bs
    stages = getattr(bs, "launch_stages", None)
    calls = ctx.window.traced_calls
    if stages is None or not calls:
        return None
    got = stages().values()
    if not any(s["calls"] for s in got):
        return None
    return sum(s["launch_ns"] for s in got) / calls / 1e3

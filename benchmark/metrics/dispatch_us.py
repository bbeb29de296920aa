"""dispatch_us.<entry>: host microseconds from a call into the
program's entry to its return, the mean over the window's calls that
ran with the tracer off (all of them where the whole window was
traced).  Layer: codec entry."""


def read(ctx, name):
    d = ctx.window.dispatch
    untraced = d[ctx.window.traced_calls:] or d
    if not untraced:
        return None
    return sum(untraced) / len(untraced) * 1e6

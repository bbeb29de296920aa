"""launches_per_call.<entry>: kernel launches the port's wrappers
counted over the window (ops/bitsliced.launch_counts, summed over the
kernels), a call.  Layer: codec entry.  Nothing to read where no
launch was counted (the plain versions on the CPU count none)."""


def read(ctx, name):
    w = ctx.window
    if not w.calls or not w.launches:
        return None
    return w.launches / w.calls

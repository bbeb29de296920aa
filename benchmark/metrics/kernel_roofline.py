"""kernel_roofline.<entry>: the share of the card's roofline that the
device work of the traced calls reaches: their problem's least time
(harness/roofline.py, from the shapes) over the time the device trace
gives every kernel, copy and fill of those calls.  Layer: kernels.
Nothing to read without a trace or a peak for the card."""


def read(ctx, name):
    if ctx.trace is None or ctx.least_traced_s is None \
            or ctx.trace.device_s <= 0:
        return None
    return 100.0 * ctx.least_traced_s / ctx.trace.device_s

"""FAST+NMS's share of its bound: the least time the card could take for the
frame's pyramid pixels (slambench/roofline.py: 103 fp32 operations and 8
bytes a pixel, against the published H100 peaks) over the kernel's mean
device time in the traced stretch."""

from slambench import roofline

KERNEL = "fast_nms_kernel"


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    times = [b - a for name, a, b in zip(trace.op_names, trace.op_start, trace.op_end) if KERNEL in name]
    if not times:
        return None
    bound_s, _ = roofline.fast_nms_bound_s(ctx.pyramid_pixels)
    return 100.0 * bound_s / (sum(times) / len(times) / 1e6)

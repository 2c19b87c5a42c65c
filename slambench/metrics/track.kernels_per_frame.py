"""Kernels launched inside the `tracker/frontend` and `tracker/track_core`
spans of the traced stretch (each kernel paired with its launch call by
correlation id), per frame the front-end ran on."""

SPANS = ("tracker/frontend", "tracker/track_core")


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    frames = trace.frames
    if not frames:
        return None
    return float(trace.kernels_launched_in(SPANS).sum()) / frames

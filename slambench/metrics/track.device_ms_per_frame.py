"""Device time of the kernels launched inside the `tracker/frontend` and
`tracker/track_core` spans of the traced stretch, per frame the front-end ran
on."""

SPANS = ("tracker/frontend", "tracker/track_core")


def read(ctx):
    trace = ctx.trace
    if trace is None:
        return None
    frames = trace.frames
    if not frames:
        return None
    mask = trace.kernels_launched_in(SPANS)
    return float((trace.op_end[mask] - trace.op_start[mask]).sum()) / 1e3 / frames

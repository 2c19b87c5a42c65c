"""Share of the traced stretch in which no operation ran on the device:
100 x (1 - the union of the device operations' intervals / the stretch's wall
time). The profiler slows the host, which sets the pace, so this reads higher
than in an untraced run."""


def read(ctx):
    trace = ctx.trace
    if trace is None or trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.wall_s)

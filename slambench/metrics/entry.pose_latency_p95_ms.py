"""The 95th percentile, over the frames handed in during the window, of the
wait from a frame's arrival (in a closed loop, the start of the call that
hands it in) to the return of the call after which its record exists: what
a consumer of poses waits. Frames whose wait overlaps the profiled stretch
are left out: the profiler slows the host, which sets the pace."""


def read(ctx):
    return ctx.latency_p95_ms

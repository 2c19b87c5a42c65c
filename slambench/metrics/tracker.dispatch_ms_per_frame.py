"""The tracker's `dispatch` timer over the whole window, per frame handed in:
the host time that launches the front-end and the tracking core, with the
per-frame read inside the tracking core."""


def read(ctx):
    if not ctx.frames or "dispatch" not in ctx.timer_s:
        return None
    return 1e3 * ctx.timer_s["dispatch"] / ctx.frames

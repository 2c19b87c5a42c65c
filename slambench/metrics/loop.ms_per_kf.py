"""The `loop` timer over the whole window (place recognition and loop
detection, and a closure where one happens), per keyframe made in the window."""


def read(ctx):
    if not ctx.keyframes or "loop" not in ctx.timer_s:
        return None
    return 1e3 * ctx.timer_s["loop"] / ctx.keyframes

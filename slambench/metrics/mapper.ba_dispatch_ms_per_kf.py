"""The local mapper's `mapper/ba_dispatch` timer over the whole window (local
BA problem assembly and launch), per keyframe made in the window."""


def read(ctx):
    if not ctx.keyframes or "mapper/ba_dispatch" not in ctx.timer_s:
        return None
    return 1e3 * ctx.timer_s["mapper/ba_dispatch"] / ctx.keyframes

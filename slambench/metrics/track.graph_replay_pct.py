"""The share of the frames through the tracker's front-ends, since the tracker
was made (the pre-roll included), whose every stage ran as a CUDA-graph
replay: the program's own counters `frontend_frames` and `replayed_frames`.
A program without them reports nothing."""


def read(ctx):
    tracker = ctx.system.tracker
    frames = getattr(tracker, "frontend_frames", None)
    replayed = getattr(tracker, "replayed_frames", None)
    if not frames or replayed is None:
        return None
    return 100.0 * replayed / frames

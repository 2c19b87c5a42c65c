from slam_framework_torch.viz.publisher import (
    CallbackSink,
    JsonlSink,
    MapPublisher,
    MemorySink,
    Snapshot,
    axis_remap,
    save_ply,
)

__all__ = [
    "MapPublisher",
    "Snapshot",
    "MemorySink",
    "JsonlSink",
    "CallbackSink",
    "axis_remap",
    "save_ply",
]

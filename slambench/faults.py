"""Faults planted under the timed path, to see the check come out false
(`slambench/tests/test_slambench_faults.py`) and to read the check's numbers
on a broken program (`python -m slambench.calibrate --fault <name>`). Each
plants into the built system as the window opens; `FAULTS` names the ones
that take the system alone."""

from __future__ import annotations

import torch


def stuck_state(system) -> None:
    """The tracking step returns its state unchanged: every frame keeps the
    pose it came in with."""
    tracker = system.tracker
    core = tracker._track_core

    def stuck(state, fd, block):
        _new_state, summary, *rest = core(state, fd, block)
        summary = summary.clone()
        summary[0:16] = state.pose.reshape(-1)
        return (state, summary, *rest)

    tracker._track_core = stuck


def frozen_pose(system) -> None:
    """The local-map pose optimisation's result is dropped: every frame keeps
    the motion model's prediction, and the motion model its velocity."""
    from slam_framework_torch.geometry import se3

    tracker = system.tracker
    core = tracker._track_core

    def frozen(state, fd, block):
        new_state, summary, *rest = core(state, fd, block)
        pred = se3.compose(state.velocity, state.pose)
        summary = summary.clone()
        summary[0:16] = pred.reshape(-1)
        return (new_state._replace(pose=pred, velocity=state.velocity), summary, *rest)

    tracker._track_core = frozen


def dropped_ba(system) -> None:
    """The local mapper's bundle adjustments run and are never written back
    to the map: keyframe poses and points keep their first estimates."""
    mapper = system.tracker.local_mapper
    mapper._apply_ba = lambda pending, prefetched=None: None


FAULTS = {"stuck_state": stuck_state, "frozen_pose": frozen_pose, "dropped_ba": dropped_ba}


def _patch_fast(break_maps):
    from slam_framework_torch.ops import fast_cuda

    original = fast_cuda.fast_nms_strength_levels

    def broken(levels):
        return break_maps(original(levels))

    def plant(_system) -> None:
        fast_cuda.fast_nms_strength_levels = broken

    def restore() -> None:
        fast_cuda.fast_nms_strength_levels = original

    return plant, restore


def half_fast():
    """Half of the batch left out: the FAST maps of the second half of the
    frame's pyramid images are never computed. Returns (plant, restore)."""
    return _patch_fast(lambda maps: maps[: len(maps) // 2] + [torch.zeros_like(m) for m in maps[len(maps) // 2:]])


def altered_fast():
    """An answer altered where it is produced: the strongest FAST response of
    the first image raised by one. Returns (plant, restore)."""
    def alter(maps):
        m = maps[0].clone()
        m.view(-1)[int(torch.argmax(m))] += 1.0
        return [m] + list(maps[1:])

    return _patch_fast(alter)

"""The check catches the timed path broken underneath. Each case drives the
rest of a run on the CPU at a small size (`conftest.tiny_spec`), skipping the
harness's look for a card, with one fault of `slambench/faults.py` planted as
the window opens:

- the tracking step returns its state unchanged;
- half of the batch left out (the FAST maps of half the pyramid's images
  never computed);
- an answer altered where it is produced (one FAST strength changed).

The exchange between chips has no place here: each cell runs on one card.
The faults read on the card for the pose and map limits (`frozen_pose`,
`dropped_ba`) are held here to plant what they say."""

import json
import types

import pytest
import torch

from slambench import faults, harness, manifest
from slambench.tests.conftest import tiny_spec

LIMITS = manifest.load_json(manifest.limits_path("kitti-stereo.drive"))
SECONDS = 25.0  # three or more chunks of four frames on a slow, shared CPU


def _run(config_file, mix, fault=None):
    torch.manual_seed(0)
    return harness.run_cell(config_file, mix, LIMITS, 2**31 + 5, SECONDS, False, 0.0, device="cpu", fault=fault,
                            log=lambda _msg: None)


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "kitti-stereo.json"
    path.write_text(json.dumps(tiny_spec("kitti-stereo")))
    mix = dict(manifest.load_json(manifest.mix_path("drive")), world_frames=120, preroll_frames=12)
    return str(path), mix, _run(str(path), mix)


def test_sound_run_holds(sound):
    _path, _mix, res = sound
    n = res["numbers"]
    assert n["fast_frames"] >= 1 and n["fast_mismatch_px"] == 0.0 and n["pyramid_max_err"] < 1e-3
    assert n["pose_ate_m"] < 0.5 and res["window"]["failed"] == 0 and n["lost_share"] == 0.0


def test_state_left_unchanged_fails(sound):
    path, mix, ok = sound
    res = _run(path, mix, fault=faults.stuck_state)
    assert not res["correct"]
    # the tracker loses the street (no pose to compare: NaN) or drifts far off it
    assert not res["numbers"]["pose_ate_m"] <= 10 * ok["numbers"]["pose_ate_m"]


@pytest.mark.parametrize("make", [faults.half_fast, faults.altered_fast])
def test_fast_fault_fails(sound, make):
    path, mix, _ok = sound
    plant, restore = make()
    try:
        res = _run(path, mix, fault=plant)
    finally:
        restore()
    assert not res["correct"] and not res["checks"]["fast_mismatch_px"]["ok"]


def test_frozen_pose_keeps_the_motion_models_prediction():
    from slam_framework_torch.geometry import se3
    from slam_framework_torch.pipeline.tracker import DeviceTrackState

    def pose(yaw, x):
        return se3.rt_to_mat(se3.so3_exp(torch.tensor([0.0, yaw, 0.0])), torch.tensor([x, 0.0, 1.0]))

    state = DeviceTrackState(pose(0.1, 2.0), pose(0.01, 0.3), *([None] * 6))
    optimised = state._replace(pose=pose(0.3, 5.0), velocity=pose(0.02, 0.5))

    def core(_state, _fd, _block):
        return optimised, torch.cat([optimised.pose.reshape(-1), torch.arange(7.0)]), "pack"

    system = types.SimpleNamespace(tracker=types.SimpleNamespace(_track_core=core))
    faults.FAULTS["frozen_pose"](system)
    new_state, summary, pack = system.tracker._track_core(state, None, None)
    pred = se3.compose(state.velocity, state.pose)
    assert torch.equal(new_state.pose, pred) and torch.equal(new_state.velocity, state.velocity)
    assert torch.equal(summary[:16], pred.reshape(-1)) and torch.equal(summary[16:], torch.arange(7.0))
    assert pack == "pack"


def test_dropped_ba_writes_nothing_back():
    calls = []
    mapper = types.SimpleNamespace(_apply_ba=lambda pending, prefetched=None: calls.append(pending))
    system = types.SimpleNamespace(tracker=types.SimpleNamespace(local_mapper=mapper))
    faults.FAULTS["dropped_ba"](system)
    assert mapper._apply_ba({"res": None}, prefetched=[1, 2, 3, 4]) is None and calls == []

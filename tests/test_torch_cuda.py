"""Card-only checks of the port's CUDA kernel and of the tracker's stage graphs.
This file imports neither jax nor the reference package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: none — the kernel computes the same fp32 min/max/compare chain as
its plain version, on the whole map, and a replayed stage graph runs the same
kernels on the same inputs as the stage run eagerly.
"""

import numpy as np
import pytest
import torch

from slam_framework_torch.ops import fast_cuda

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _images(shapes, dev, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, s).astype(np.float32)).to(dev) for s in shapes]


@pytest.mark.parametrize("shape", [(2, 376, 1241), (1, 105, 346), (2, 75, 140), (1, 1, 1), (3, 33, 65)])
def test_kernel_matches_plain_on_card(shape):
    dev = _card()
    (img,) = _images([shape], dev)
    before = fast_cuda.launches
    got = fast_cuda.fast_nms_strength(img)
    torch.cuda.synchronize()
    assert fast_cuda.launches == before + 1
    assert torch.equal(got, fast_cuda.fast_nms_strength_plain(img))


@pytest.mark.parametrize("shapes", [
    [(376, 1241), (7, 5), (105, 346), (200, 17), (1, 1), (33, 121), (32, 120), (31, 119)],
    [(40, 50)] * 33,  # more images than one launch's table holds
])
def test_levels_match_plain_on_mixed_shapes_in_one_launch(shapes):
    dev = _card()
    imgs = _images(shapes, dev)
    imgs[0] = imgs[0] * 0.37 + 0.11  # values that are not whole numbers
    imgs[1] = imgs[1] * 0.37 - 47.3  # of both signs
    imgs[-1] = -imgs[-1]
    imgs[-1][::3, ::2] = -0.0
    before = fast_cuda.launches
    got = fast_cuda.fast_nms_strength_levels(imgs)
    torch.cuda.synchronize()
    assert fast_cuda.launches == before + -(-len(shapes) // fast_cuda.MAX_IMAGES)
    assert [tuple(g.shape) for g in got] == [tuple(s) for s in shapes]
    for g, img in zip(got, imgs):
        assert torch.equal(g, fast_cuda.fast_nms_strength_plain(img))


def test_batch_larger_than_one_table_matches_plain():
    dev = _card()
    (img,) = _images([(40, 33, 65)], dev)
    assert torch.equal(fast_cuda.fast_nms_strength(img), fast_cuda.fast_nms_strength_plain(img))


def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    with pytest.raises(TypeError):
        fast_cuda.fast_nms_strength(torch.zeros(1, 8, 8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength(torch.zeros(8, 16, device=dev).T)


def test_levels_reject_what_the_kernel_does_not_take():
    dev = _card()
    ok = torch.zeros(8, 8, device=dev)
    with pytest.raises(TypeError):
        fast_cuda.fast_nms_strength_levels([ok, torch.zeros(8, 8, dtype=torch.float16, device=dev)])
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength_levels([ok, torch.zeros(8, 16, device=dev).T])
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength_levels([ok, torch.zeros(2, 8, 8, device=dev)])
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength_levels([ok, torch.zeros(8, 8)])  # one on the card, one not
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength_levels([torch.zeros(8, 8), ok])


def test_system_takes_the_card_by_default():
    _card()
    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.system import SlamSystem

    assert SlamSystem(SlamConfig()).device.type == "cuda"


@pytest.mark.parametrize("sensor", ["rgbd", "monocular"])
def test_rgbd_and_mono_frontends_launch_once_over_their_8_levels(sensor):
    dev = _card()
    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.ops import pyramid
    from slam_framework_torch.pipeline.frame import MonoFrontend, RgbdFrontend

    cfg = SlamConfig(sensor=sensor)
    (img,) = _images([(cfg.camera.height, cfg.camera.width)], dev, seed=5)
    levels = pyramid.build_pyramid(img, cfg.orb.num_levels, cfg.orb.scale_factor)
    before = fast_cuda.launches
    got = fast_cuda.fast_nms_strength_levels(levels)
    assert fast_cuda.launches == before + 1
    for g, lvl in zip(got, levels):
        assert torch.equal(g, fast_cuda.fast_nms_strength_plain(lvl))
    before = fast_cuda.launches
    if sensor == "rgbd":
        fd = RgbdFrontend(cfg)(img, torch.full_like(img, 7.5))
        assert bool(((fd.depth == 7.5) == fd.valid).all())
    else:
        fd = MonoFrontend(cfg)(img.to(torch.uint8))
        assert bool((fd.depth == -1).all())
    torch.cuda.synchronize()
    assert fast_cuda.launches == before + 1 and int(fd.valid.sum()) > 500


@pytest.mark.parametrize("sensor", ["rgbd", "monocular"])
def test_rgbd_and_mono_systems_take_the_card_by_default(sensor):
    _card()
    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.system import SlamSystem

    system = SlamSystem(SlamConfig(sensor=sensor), place_recognition=False)
    assert system.device.type == "cuda" and system.tracker.device.type == "cuda"


N_DRIVE = 44  # frames of the bench world: depth 2 from its fourth keyframe, a keyframe every few frames


@pytest.fixture(scope="module")
def replayed_and_eager():
    """The same bench-world frames through two trackers on the card: one
    replaying its stage graphs, one running the same stages eagerly (its
    capture hook refused)."""
    dev = _card()
    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.pipeline import stage_graphs
    from slam_framework_torch.pipeline.tracker import StereoTracker
    from slam_framework_torch.tools.track_bench_world import bench_world

    cfg = SlamConfig()
    world = bench_world(cfg, N_DRIVE)
    pairs = [world.stereo_pair(f) for f in range(N_DRIVE)]
    runs = {}
    for name in ("replayed", "eager"):
        with pytest.MonkeyPatch.context() as mp:
            if name == "eager":
                mp.setattr(stage_graphs.StageGraphs, "_capturable", lambda self: False)
            tracker = StereoTracker(cfg, sync_every=4, device=dev)
            tracker.MATURE_MAP_KFS = 4
            frames, staged = [], tracker._run_frame

            def recorded(frame, block, staged=staged, frames=frames, tracker=tracker):
                out = staged(frame, block)
                frames.append([t.clone() for t in out[:3]] + [t.clone() for t in tracker._dstate])
                return out

            tracker._run_frame = recorded
            before = fast_cuda.launches
            for f in range(N_DRIVE):
                tracker.track(*pairs[f], world.timestamps[f])
            tracker.flush()
            torch.cuda.synchronize()
            runs[name] = {"tracker": tracker, "frames": frames, "launches": fast_cuda.launches - before}
    return runs


def test_replayed_stages_are_bit_equal_to_the_same_stages_run_eagerly(replayed_and_eager):
    rep, eag = replayed_and_eager["replayed"], replayed_and_eager["eager"]
    assert len(rep["frames"]) == len(eag["frames"]) == N_DRIVE - 1
    names = ("summary", "pack", "desc") + tuple(f"state.{n}" for n in rep["tracker"]._dstate._fields)
    for k, (a, b) in enumerate(zip(rep["frames"], eag["frames"])):
        for name, x, y in zip(names, a, b, strict=True):
            assert torch.equal(x, y), (k, name, float((x.double() - y.double()).abs().max()))
    ta, tb = rep["tracker"], eag["tracker"]
    assert [r.lost for r in ta.records] == [r.lost for r in tb.records] == [False] * N_DRIVE
    for ra, rb in zip(ta.records, tb.records):
        assert np.array_equal(ra.pose, rb.pose)
    # a keyframe's block rebuild and remap crossed, at depth 2
    assert ta.arena.num_kfs >= 6 and ta._current_depth() == 2


def test_replays_launch_fast_once_per_frame_and_capture_once_per_stage(replayed_and_eager):
    rep, eag = replayed_and_eager["replayed"], replayed_and_eager["eager"]
    for run in (rep, eag):
        assert run["launches"] == run["tracker"].frontend_frames == N_DRIVE
    ta = rep["tracker"]
    stages = [key[0] for key in ta._stage_graphs._graphs]
    assert sorted(stages) == sorted({"levels", "features", "motion", "local"} | set(stages) & {"fallback"})
    assert ta.graph_captures == len(stages)
    # every dispatched frame replays but the first, and the one that captured the fallback
    assert ta.replayed_frames >= N_DRIVE - 1 - 1 - ("fallback" in stages)
    tb = eag["tracker"]
    assert (tb.replayed_frames, tb.graph_captures, tb.fallback_replays) == (0, 0, 0)

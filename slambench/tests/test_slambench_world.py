"""The renderer copy against the port's synthetic renderer, and the world
made from the seed."""

import numpy as np
import torch

from slambench import world as W


def _port_world_in_copy(seed=5, frames=40):
    from slam_framework_torch.config import CameraConfig
    from slam_framework_torch.io import synthetic

    s = 0.25
    cam = CameraConfig(fx=718.856 * s, fy=718.856 * s, cx=607.1928 * s, cy=185.2157 * s, width=310, height=94,
                       bf=386.1448 * s)
    port = synthetic.make_world(num_frames=frames, cam=cam, seed=seed)
    surfs = [W.Surface(p.kind, p.radius, [torch.from_numpy(m) for m in p.mips], p.res, p.az0, p.wrap, p.y_top,
                       p.y_bot, p.az_span) for p in port.surfaces]
    copy = W.World(W.Camera(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.fps, cam.bf), port.poses,
                   port.timestamps, tuple(port.center), port.r_inner, port.r_outer, port.ground_y, surfs)
    return port, copy


def test_render_matches_the_port_on_its_textures():
    port, copy = _port_world_in_copy()
    for f in (0, 17, 39):
        for right in (False, True):
            want = port.render(f, right).astype(np.int32)
            poses = copy.poses[[f]]
            got = W.render(copy, copy.right_poses(poses) if right else poses, "cpu")[0].numpy().astype(np.int32)
            diff = np.abs(want - got)
            # the copy computes in float32 where the port mixes in float64: a few
            # pixels part by one level
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-2


def test_arc_poses_are_the_ports():
    from slam_framework_torch.io import synthetic

    port = synthetic.make_world(num_frames=30, seed=1, speed=1.0, yaw_rate=0.002)
    poses, ts, _ = W.arc_poses(30, 1.0, 0.002, 10.0)
    np.testing.assert_array_equal(poses, port.poses)
    np.testing.assert_allclose(ts, port.timestamps)


def test_world_is_made_from_the_seed():
    cam = W.Camera(100.0, 100.0, 80.0, 30.0, 160, 60, 10.0, 54.0)
    a = W.make_world(2**31 + 11, 60, cam, "cpu")
    b = W.make_world(2**31 + 11, 60, cam, "cpu")
    c = W.make_world(2**31 + 12, 60, cam, "cpu")
    for sa, sb, sc in zip(a.surfaces, b.surfaces, c.surfaces):
        assert torch.equal(sa.mips[0], sb.mips[0]) and not torch.equal(sa.mips[0], sc.mips[0])
        assert sa.mips[0].shape[0] % 8 == 0 and sa.mips[0].shape[1] % 8 == 0
        for lo, hi in zip(sa.mips, sa.mips[1:]):
            m = lo.to(torch.int32)
            s = m[0::2, 0::2] + m[1::2, 0::2] + m[0::2, 1::2] + m[1::2, 1::2]
            assert torch.equal(hi, ((s + 2) >> 2).to(torch.uint8))
    img = W.render(a, a.poses[:2], "cpu").float()
    assert 60 < img.mean() < 200 and img.std() > 20


def _tiny_drive(feed, sensor="stereo"):
    from slambench import manifest
    from slambench.tests.conftest import tiny_spec

    spec = tiny_spec("kitti-stereo")
    spec["camera"].update(fx=100.0, fy=100.0, cx=80.0, cy=30.0, width=160, height=60, bf=54.0)
    spec["sensor"] = sensor
    mix = dict(manifest.load_json(manifest.mix_path("drive")), world_frames=40, preroll_frames=8, feed=feed)
    return manifest.load_generator(mix["generator"])(mix, spec, 2**31 + 3, 1.0, 4, "cpu")


def test_drive_feeds_and_frames():
    closed = _tiny_drive({"kind": "closed"})
    # 8 pre-roll + 20 frames/s over 1 s + 4 of tail
    assert closed.n_frames == 32 and closed.frames.shape == (32, 2, 60, 160)
    assert closed.due_s(0) is None and closed.due_s(7) is None
    left, right = closed.frame(5)
    np.testing.assert_array_equal(closed.images(5), np.stack([left, right]))
    live = _tiny_drive({"kind": "rate", "frames_per_s": 10})
    assert live.due_s(0) == 0.0 and abs(live.due_s(7) - 0.7) < 1e-12
    np.testing.assert_array_equal(live.images(5), closed.images(5))
    mono = _tiny_drive({"kind": "closed"}, sensor="monocular")
    assert len(mono.frame(5)) == 1 and mono.images(5).shape == (1, 60, 160)
    np.testing.assert_array_equal(mono.images(5)[0], closed.images(5)[0])
    # the world's walls are at the corridor's half-width from the path
    c = closed.world.poses[0]
    centre = -c[:3, :3].T @ c[:3, 3]
    d = closed.surface_distance(np.array([centre + [10.0, 0.0, 0.0], centre + [0.0, 1.65, 0.0]]))
    np.testing.assert_allclose(d, [0.0, 0.0], atol=0.05)

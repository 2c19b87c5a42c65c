"""Per-frame front-ends: ORB extraction plus, per sensor, the depth of each feature.

Port of slam_framework_tpu/pipeline/frame.py (`FrameData`, `StereoFrontend`,
`RgbdFrontend`, `MonoFrontend`). Every front-end runs FAST+NMS over all the
level images it extracts from in ONE kernel launch: 16 for a stereo frame,
8 for an RGB-D or a monocular one.

Each front-end is two pure stages around that launch (`Frontend`): `levels`
builds the pyramids, `fast_nms_strength_levels` runs over the first `n_fast`, and
`features` extracts and measures depth. The tracker replays the two stages as
CUDA graphs (pipeline/stage_graphs.py) and makes the launch between them, through
the module attribute, once per frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.geometry import projection
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.ops import fast_cuda, stereo_match
from slam_framework_torch.ops.extractor import Features, OrbExtractor


def _undistort_if_needed(xy: torch.Tensor, cfg: SlamConfig, K: Intrinsics) -> torch.Tensor:
    """Geometry downstream uses undistorted pixels; identity when all
    coefficients are 0 (the rectified-stereo / KITTI case)."""
    cam = cfg.camera
    coeffs = (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
    if not any(coeffs):
        return xy
    return projection.undistort_points(xy, K, coeffs)


class FrameData(NamedTuple):
    """Fixed-capacity per-frame data block."""

    xy: torch.Tensor        # (N, 2) f32 level-0 pixel coords
    response: torch.Tensor  # (N,)
    angle: torch.Tensor     # (N,)
    octave: torch.Tensor    # (N,) int32
    desc: torch.Tensor      # (N, 8) int32 (uint32 bits)
    valid: torch.Tensor     # (N,) bool
    u_right: torch.Tensor   # (N,) f32, -1 if no stereo match
    depth: torch.Tensor     # (N,) f32, -1 if unknown

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


class Frontend:
    """A front-end as two pure stages around its one FAST+NMS launch: the
    staged images -> `levels` (a flat tuple of fp32 level images, the
    `n_fast` FAST inputs first) -> `fast_nms_strength_levels(levels[:n_fast])`
    -> `features(images, levels, maps)`."""

    n_fast: int  # level images that go through FAST+NMS: the first n_fast of `levels`

    def levels(self, *images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def features(self, images: Sequence[torch.Tensor], levels: Sequence[torch.Tensor],
                 maps: Sequence[torch.Tensor]) -> FrameData:
        raise NotImplementedError

    def __call__(self, *images: torch.Tensor) -> FrameData:
        levels = self.levels(*images)
        return self.features(images, levels, fast_cuda.fast_nms_strength_levels(levels[: self.n_fast]))


class StereoFrontend(Frontend):
    """left + right grayscale -> FrameData, on the images' device."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.K = Intrinsics(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy, cfg.camera.bf)
        self.extractor = OrbExtractor(cfg.orb, max_features=cfg.capacity.max_features)
        # FAST+NMS of all levels of both images in one kernel launch
        self.n_fast = 2 * cfg.orb.num_levels

    def levels(self, left: torch.Tensor, right: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Both pyramids, then both blurred pyramids; each pyramid is shared
        between extraction and stereo matching."""
        (lp, lb), (rp, rb) = self.extractor.pyramids(left), self.extractor.pyramids(right)
        return (*lp, *rp, *lb, *rb)

    def features(self, images, levels, maps) -> FrameData:
        cfg = self.cfg
        nl = cfg.orb.num_levels
        lp, rp, lb, rb = (list(levels[i * nl:(i + 1) * nl]) for i in range(4))
        fl: Features = self.extractor.extract_from_pyramid(lp, lb, maps[:nl])
        fr: Features = self.extractor.extract_from_pyramid(rp, rb, maps[nl:])
        # stereo matching searches raw rectified rows; undistortion applies to
        # the geometry coordinates only
        sm = stereo_match.match_stereo(fl, fr, lp, rp, self.K, self.extractor.scales)
        return FrameData(
            xy=_undistort_if_needed(fl.xy, cfg, self.K),
            response=fl.response,
            angle=fl.angle,
            octave=fl.octave,
            desc=fl.desc,
            valid=fl.valid,
            u_right=sm.u_right,
            depth=sm.depth,
        )


class RgbdFrontend(Frontend):
    """grayscale + registered depth map -> FrameData.

    The RGB-D Frame constructor (frame.cpp:120-158 + ComputeStereoFromRGBD
    :579-597): depth is sampled at each keypoint's rounded raw pixel and a
    virtual right-image coordinate u_r = u - bf/d is made from the undistorted
    one, so the whole stereo pipeline (tracking, the BA's stereo residuals)
    applies unchanged. Called like StereoFrontend, with (gray, depth) for
    (left, right)."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.K = Intrinsics(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy, cfg.camera.bf)
        self.extractor = OrbExtractor(cfg.orb, max_features=cfg.capacity.max_features)
        self.n_fast = cfg.orb.num_levels

    def levels(self, gray: torch.Tensor, depth: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        lp, lb = self.extractor.pyramids(gray.to(torch.uint8))
        return (*lp, *lb)

    def features(self, images, levels, maps) -> FrameData:
        cfg = self.cfg
        nl = self.n_fast
        f: Features = self.extractor.extract_from_pyramid(list(levels[:nl]), list(levels[nl:]), maps)
        depth = images[1]
        H, W = depth.shape
        # torch.round, like jnp.round, rounds half to even
        ui = torch.clamp(torch.round(f.xy[:, 0]).to(torch.int64), 0, W - 1)
        vi = torch.clamp(torch.round(f.xy[:, 1]).to(torch.int64), 0, H - 1)
        d = depth[vi, ui].to(torch.float32)
        if cfg.camera.depth_map_factor not in (0.0, 1.0):
            d = d / cfg.camera.depth_map_factor
        has = (d > 0) & f.valid
        # depth at the RAW pixel; u_right from the UNDISTORTED coordinate
        xy_un = _undistort_if_needed(f.xy, cfg, self.K)
        minus1 = torch.full_like(d, -1.0)
        u_right = torch.where(has, xy_un[:, 0] - self.K.bf / torch.clamp(d, min=1e-6), minus1)
        return FrameData(
            xy=xy_un,
            response=f.response,
            angle=f.angle,
            octave=f.octave,
            desc=f.desc,
            valid=f.valid,
            u_right=u_right,
            depth=torch.where(has, d, minus1),
        )


class MonoFrontend(Frontend):
    """One grayscale image -> FrameData with u_right = depth = -1.

    feature_multiplier scales the feature budget and the slots (the monocular
    initialization extracts twice the features, tracker.cpp:84-90)."""

    def __init__(self, cfg: SlamConfig, feature_multiplier: int = 1):
        self.cfg = cfg
        self.K = Intrinsics(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy, 0.0)
        orb = dataclasses.replace(cfg.orb, num_features=cfg.orb.num_features * feature_multiplier)
        self.extractor = OrbExtractor(orb, max_features=cfg.capacity.max_features * feature_multiplier)
        self.n_fast = cfg.orb.num_levels

    def levels(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        lp, lb = self.extractor.pyramids(img)
        return (*lp, *lb)

    def features(self, images, levels, maps) -> FrameData:
        nl = self.n_fast
        f: Features = self.extractor.extract_from_pyramid(list(levels[:nl]), list(levels[nl:]), maps)
        minus1 = torch.full((f.xy.shape[0],), -1.0, dtype=torch.float32, device=f.xy.device)
        return FrameData(
            xy=_undistort_if_needed(f.xy, self.cfg, self.K),
            response=f.response,
            angle=f.angle,
            octave=f.octave,
            desc=f.desc,
            valid=f.valid,
            u_right=minus1,
            depth=minus1.clone(),
        )

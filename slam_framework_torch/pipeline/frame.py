"""Per-frame stereo front-end: extraction + stereo association.

Port of slam_framework_tpu/pipeline/frame.py (`FrameData`, `StereoFrontend`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.geometry import projection
from slam_framework_torch.geometry.projection import Intrinsics
from slam_framework_torch.ops import fast_cuda, pyramid, stereo_match
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


class StereoFrontend:
    """left + right grayscale -> FrameData, on the images' device."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.K = Intrinsics(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy, cfg.camera.bf)
        self.extractor = OrbExtractor(cfg.orb, max_features=cfg.capacity.max_features)

    def __call__(self, left: torch.Tensor, right: torch.Tensor) -> FrameData:
        cfg = self.cfg
        nl, sf = cfg.orb.num_levels, cfg.orb.scale_factor
        # one pyramid per image, shared between extraction and stereo matching
        lf32 = left.to(torch.float32).contiguous()
        rf32 = right.to(torch.float32).contiguous()
        lp = pyramid.build_pyramid(lf32, nl, sf)
        rp = pyramid.build_pyramid(rf32, nl, sf)
        lb = pyramid.build_blurred_pyramid(lf32, nl, sf)
        rb = pyramid.build_blurred_pyramid(rf32, nl, sf)
        # FAST+NMS of all levels of both images in one kernel launch
        nms = fast_cuda.fast_nms_strength_levels(lp + rp)
        fl: Features = self.extractor.extract_from_pyramid(lp, lb, nms[:nl])
        fr: Features = self.extractor.extract_from_pyramid(rp, rb, nms[nl:])
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

"""ORB extractor: pyramid -> FAST+NMS -> uniform select -> orientation -> rBRIEF.

Port of slam_framework_tpu/ops/extractor.py (`_extract`, `_extract_from_pyramid`). All
outputs are fixed-shape (max_features slots + validity mask). `xy` is in
level-0 pixels, `octave` is the pyramid level.

FAST+NMS goes through ops/fast_cuda.fast_nms_strength_levels: the hand-written
CUDA kernel for tensors on the card, its plain version for CPU tensors. The
stereo front-end computes the maps of both pyramids in one launch and hands
each extraction its own; an extraction that is given none computes them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from slam_framework_torch.config import OrbConfig
from slam_framework_torch.ops import brief, fast, fast_cuda, orient, pyramid, select

DETECT_MARGIN = 16  # = EDGE_THRESHOLD - 3 (reference orb_extractor.cpp:707-713)


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set."""

    xy: torch.Tensor        # (N, 2) fp32 — level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) fp32
    angle: torch.Tensor     # (N,) fp32 radians
    octave: torch.Tensor    # (N,) int32 pyramid level
    desc: torch.Tensor      # (N, 8) int32 packed 256-bit descriptors
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


class OrbExtractor:
    def __init__(self, cfg: OrbConfig, max_features: int | None = None):
        self.cfg = cfg
        self.max_features = max_features or cfg.num_features
        self.scales = pyramid.scale_factors(cfg.num_levels, cfg.scale_factor)
        self.per_level = pyramid.features_per_level(
            self.max_features, cfg.num_levels, cfg.scale_factor
        )

    def pyramids(self, img: torch.Tensor):
        """The fp32 pyramid and blurred pyramid of one (H, W) grayscale image, uint8 or fp32."""
        img = img.to(torch.float32).contiguous()
        nl, sf = self.cfg.num_levels, self.cfg.scale_factor
        return pyramid.build_pyramid(img, nl, sf), pyramid.build_blurred_pyramid(img, nl, sf)

    def extract(self, img: torch.Tensor) -> Features:
        """Features of one (H, W) grayscale image, uint8 or fp32: its pyramid and
        blurred pyramid, then `extract_from_pyramid` (one FAST+NMS launch)."""
        return self.extract_from_pyramid(*self.pyramids(img))

    def extract_from_pyramid(self, levels: List[torch.Tensor], blurred: List[torch.Tensor],
                             nms_maps: Optional[Sequence[torch.Tensor]] = None) -> Features:
        """Features from a prebuilt fp32 pyramid and its blurred levels.
        nms_maps: fast_nms_strength_levels(levels), where the caller has it."""
        cfg = self.cfg
        # one strength map + one NMS per level serves both FAST thresholds
        # (suppression only comes from a strictly stronger neighbour)
        if nms_maps is None:
            nms_maps = fast_cuda.fast_nms_strength_levels(levels)
        feats = []
        for lvl, lvl_img in enumerate(levels):
            n_lvl = self.per_level[lvl]
            if n_lvl <= 0:
                continue
            strength = fast.mask_border(nms_maps[lvl], DETECT_MARGIN)
            zero = torch.zeros_like(strength)
            score_hi = torch.where(strength > float(cfg.ini_thresh_fast), strength, zero)
            score_lo = torch.where(strength > float(cfg.min_thresh_fast), strength, zero)
            sel = select.select_uniform(score_hi, score_lo, n_lvl, cell=cfg.fast_cell_size)

            wins = brief.fused_windows(lvl_img, blurred[lvl], sel.xy)
            angles = orient.ic_angles_from_windows(
                wins[..., 0], brief.MAX_ROTATED_OFFSET - orient.HALF_PATCH
            )
            desc = brief.descriptors_from_windows(wins[..., 1].reshape(wins.shape[0], -1), angles)
            feats.append(
                Features(
                    xy=sel.xy.to(torch.float32) * float(self.scales[lvl]),
                    response=sel.response,
                    angle=angles,
                    octave=torch.full((n_lvl,), lvl, dtype=torch.int32, device=lvl_img.device),
                    desc=desc,
                    valid=sel.valid,
                )
            )

        cat = Features(*[torch.cat([f[i] for f in feats], dim=0) for i in range(len(Features._fields))])
        # pad or trim to the fixed capacity
        n = cat.xy.shape[0]
        cap = self.max_features
        if n < cap:
            pad = cap - n
            cat = Features(*[F.pad(a, (0, 0, 0, pad)) if a.dim() == 2 else F.pad(a, (0, pad))
                             for a in cat])
        elif n > cap:
            cat = Features(*[a[:cap] for a in cat])
        return cat

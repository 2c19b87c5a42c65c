"""What decides `correct`: the timed path's outputs against the plain reference.

Four things the window produced are compared, each at the timed sizes and
from the run itself:

- the poses the window returned, against the ground truth of the world the
  benchmark made (`pose_ate_m`: aligned RMSE of the camera centres; SE3, or
  Sim3 where the sensor leaves the scale free; `pose_rpe10_m` and
  `pose_rpe10_median_m`: the RMSE and the median of the error of the motion
  over 10 frames, at the alignment's scale);
- the front-end's FAST+NMS maps on frames drawn from the seed among those
  the window dispatched, recorded where the front-end makes them, against
  `reference.fast_nms` on the same level images (`fast_mismatch_px`, exact);
  the levels themselves come from the program's pyramid, so that stage is
  checked on its own against `reference.pyramid` of the frame's raw pixels
  (`pyramid_max_err`, level 0 included);
- the map's points, each carried into the ground-truth world through a
  keyframe that observes it (its estimated pose, scaled by the window's Sim3
  scale where the scale is free, then the keyframe's true pose), against the
  world's surfaces (`map_surface_median_m`, `map_surface_p90_m`);
- the frames handed in during the window that came back lost or never came
  back (`lost_share`, of those handed in).

Each compared number has a limit in `slambench/limits/<workload>.json`; a
number without a limit there is printed and not compared. NaN (nothing to
compare) fails.
"""

from __future__ import annotations

import ast
import math
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from slambench import reference

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_framework_tpu")
PROGRAM = "slam_framework_torch"
RPE_STEP = 10


class FastRecorder:
    """Keeps the level images and the NMS'd FAST maps that the front-end
    computes for a sample of the window's frames: `count` frames drawn
    uniformly, by reservoir, from those dispatched while it is active (from the
    first frame of the window to its close), with draws from `rng`. It wraps
    the tracker's `_dispatch`, which runs the front-end once per buffered frame
    in order, to know which frame each FAST call serves; calls outside a
    dispatch (the monocular initializer, relocalization) are not recorded."""

    def __init__(self, rng: np.random.Generator, first: int, count: int):
        self.rng = rng
        self.first = first
        self.count = count
        self.active = True
        self.seen = 0
        self.captured: Dict[int, tuple] = {}
        self._fids: List[int] = []
        self._restore = None

    def _keep(self, fid: int) -> Optional[int]:
        """The frame whose slot this one takes (reservoir sampling), -1 for a
        free slot, None if it is not kept."""
        if not self.active or fid < self.first:
            return None
        self.seen += 1
        if len(self.captured) < self.count:
            return -1
        j = int(self.rng.integers(self.seen))
        return sorted(self.captured)[j] if j < self.count else None

    def install(self, tracker, fast_module) -> None:
        dispatch = tracker._dispatch

        def recorded_dispatch():
            self._fids = [fid for _frame, fid, _ts in tracker._buf]
            try:
                dispatch()
            finally:
                self._fids = []

        original = fast_module.fast_nms_strength_levels

        def recorded_fast(levels):
            maps = original(levels)
            if self._fids:
                fid = self._fids.pop(0)
                slot = self._keep(fid)
                if slot is not None:
                    self.captured.pop(slot, None)
                    self.captured[fid] = ([t.clone() for t in levels], [m.clone() for m in maps])
            return maps

        tracker._dispatch = recorded_dispatch
        fast_module.fast_nms_strength_levels = recorded_fast
        self._restore = (fast_module, original)

    def uninstall(self) -> None:
        if self._restore is not None:
            module, original = self._restore
            module.fast_nms_strength_levels = original
            self._restore = None

    def to_host(self) -> Dict[int, tuple]:
        return {fid: ([t.cpu().numpy() for t in lv], [m.cpu().numpy() for m in mp])
                for fid, (lv, mp) in self.captured.items()}


def fast_numbers(captured: Dict[int, tuple], images: Callable[[int], np.ndarray], num_levels: int,
                 scale_factor: float) -> Dict[str, float]:
    """Exact FAST+NMS mismatch over the recorded frames, and the pyramid's
    largest departure from the float64 reference of the raw pixels
    (`images(f)`: frame f's (I, H, W) uint8 images)."""
    mismatch = 0
    pyr_err = 0.0
    for fid, (levels, maps) in sorted(captured.items()):
        raw = images(fid)
        for i in range(len(levels) // num_levels):
            ref_levels = reference.pyramid(raw[i], num_levels, scale_factor)
            for lvl in range(num_levels):
                got = levels[i * num_levels + lvl]
                pyr_err = max(pyr_err, float(np.abs(got.astype(np.float64) - ref_levels[lvl]).max()))
                mismatch += int((reference.fast_nms(got) != maps[i * num_levels + lvl]).sum())
    if not captured:
        return {"fast_frames": 0, "fast_mismatch_px": math.nan, "pyramid_max_err": math.nan}
    return {"fast_frames": len(captured), "fast_mismatch_px": float(mismatch), "pyramid_max_err": pyr_err}


def pose_numbers(est: Dict[int, np.ndarray], gt: np.ndarray, frames, free_scale: bool) -> Dict[str, float]:
    """ATE and RPE of the window's returned poses; also the alignment scale."""
    fids = [f for f in frames if est.get(f) is not None]
    if len(fids) < 3:
        return {"pose_frames": len(fids), "pose_ate_m": math.nan, "pose_rpe10_m": math.nan,
                "pose_rpe10_median_m": math.nan, "scale": math.nan}
    e = np.stack([est[f] for f in fids]).astype(np.float64)
    g = gt[fids].astype(np.float64)
    ate, scale = reference.ate(e, g, with_scale=free_scale)
    have = set(fids)
    pairs = [f for f in fids if f + RPE_STEP in have]
    if pairs:
        later = [f + RPE_STEP for f in pairs]
        err = reference.motion_errors(np.stack([est[f] for f in pairs]), np.stack([est[f] for f in later]),
                                      gt[pairs], gt[later], scale)
        rpe, rpe_median = float(np.sqrt(np.mean(err ** 2))), float(np.median(err))
    else:
        rpe = rpe_median = math.nan
    return {"pose_frames": len(fids), "pose_ate_m": ate, "pose_rpe10_m": rpe, "pose_rpe10_median_m": rpe_median,
            "scale": scale}


def map_numbers(m: dict, gt: np.ndarray, scale: float,
                surface_distance: Callable[[np.ndarray], np.ndarray]) -> Dict[str, float]:
    """Distances of the map's points to the world's surfaces, each point
    carried into the true world through an observing keyframe."""
    valid = np.nonzero(m["pt_valid"])[0]
    kf_valid = m["kf_valid"]
    obs = m["pt_obs_kf"][valid]
    first = m["pt_first_kf"][valid]
    nk = len(kf_valid)
    cand = np.concatenate([first[:, None], obs], axis=1)
    ok = (cand >= 0) & (cand < nk) & kf_valid[np.clip(cand, 0, nk - 1)]
    has = ok.any(axis=1)
    kf = cand[np.arange(len(cand)), ok.argmax(axis=1)][has]
    pts = m["pt_pos"][valid][has].astype(np.float64)
    if len(pts) == 0 or not math.isfinite(scale):
        return {"map_points": 0, "map_surface_median_m": math.nan, "map_surface_p90_m": math.nan}
    T = m["kf_pose"][kf].astype(np.float64)
    x_cam = scale * (np.einsum("nij,nj->ni", T[:, :3, :3], pts) + T[:, :3, 3])
    G = gt[m["kf_frame_id"][kf]].astype(np.float64)
    x_w = np.einsum("nji,nj->ni", G[:, :3, :3], x_cam - G[:, :3, 3])
    d = surface_distance(x_w)
    return {"map_points": int(len(d)), "map_surface_median_m": float(np.median(d)),
            "map_surface_p90_m": float(np.percentile(d, 90))}


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> Dict[str, dict]:
    """Each limited number beside its limit, and whether it held."""
    out = {}
    for name, spec in limits.items():
        value = float(numbers.get(name, math.nan))
        out[name] = {"value": value, "limit": float(spec["limit"]),
                     "ok": bool(math.isfinite(value) and value <= float(spec["limit"]))}
    return out


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may hold (whole names:
    the program's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def reference_imports_program() -> Optional[str]:
    """Why the reference is not plain, or None: it may import nothing of the
    program (by its source) and hold nothing of it (at run time)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            if n.split(".")[0] in (PROGRAM,) + FORBIDDEN:
                return f"slambench/reference.py imports {n}"
    for key, value in vars(reference).items():
        mod = getattr(value, "__module__", None) or getattr(value, "__name__", "")
        if isinstance(mod, str) and mod.split(".")[0] in (PROGRAM,) + FORBIDDEN:
            return f"slambench.reference holds {key} from {mod}"
    return None

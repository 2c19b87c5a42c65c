"""Synthetic stereo/mono/RGB-D sequence generator with exact ground truth.

The reference is only ever exercised on KITTI files; this module provides the
equivalent test/benchmark input without dataset access (SURVEY.md §4: module tests on
synthetic scenes with known geometry).

Design: a RAY-CAST world of continuous textured surfaces — two concentric
cylindrical walls plus a ground annulus, concentric with the arc the camera
drives (the constant-yaw-rate trajectories `make_world` generates are circle
arcs, so the corridor walls are exactly cylinders). Every image pixel lies on
a rigid textured surface with exact depth, like real imagery: descriptors
stay stable under viewpoint change because neighboring pixels share a surface
(the previous sprite-field renderer put isolated <15 px sprites against
background — smaller than the 31 px BRIEF patch, so descriptors blended
parallax-shuffled neighbors and even OpenCV ORB found <15% consecutive-frame
matches; that starved tracking in a way real KITTI footage does not).

Rendering is host-side numpy (a handful of vectorized surface
intersections + mip-mapped texture lookups per frame); it feeds the same
entry points a KITTI loader would.

Port of slam_framework_tpu/io/synthetic.py (`make_world`, `make_figure_eight_world`, the stereo pair
and the RGB-D pair `rgbd_pair` / `render_depth`) without cv2:
the bilinear remap, bicubic and area resizes and the filled ellipse / box
stamps are written out in numpy after OpenCV's definitions. The random
number stream is consumed in the same order, so poses, timestamps and stamp
parameters equal the reference world's exactly; pixels differ slightly where
the numpy rasterisation and resampling round differently.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from slam_framework_torch.config import CameraConfig

_BG = 90          # sky / beyond-fade intensity
_T_MIN = 0.5      # nearest render distance (camera-frame z, meters)
_N_MIPS = 4
_FADE_M = 150.0   # distance fade (far content loses contrast, like haze)


@dataclasses.dataclass
class _Surface:
    """One textured surface strip parameterized by (azimuth, second coord)."""

    kind: str                 # "cyl" | "ground"
    radius: float             # cylinder radius (cyl) — unused for ground
    mips: List[np.ndarray]    # texture mip chain, level 0 first
    res: float                # texture px per meter at level 0
    az0: float                # azimuth of texture column 0
    wrap: bool                # full-circle azimuth wrap vs clamped strip
    y_top: float = 0.0        # upper edge (min y; y points down) — cyl only
    y_bot: float = 0.0        # lower edge (max y) — cyl only
    # Per-surface turn-circle center: multi-circuit worlds (figure-eight)
    # have surfaces concentric with DIFFERENT arcs. None = the world's center.
    center: Tuple[float, float] | None = None
    # Azimuthal validity span from az0 (radians): hits outside pass through.
    # A figure-eight's walls are opened around the crossing (az_span < 2*pi).
    az_span: float = 2.0 * np.pi
    # ground-annulus radial validity (ground only); None = the world's r_outer
    r_lo: float | None = None
    r_hi: float | None = None


@dataclasses.dataclass
class SyntheticWorld:
    cam: CameraConfig
    poses: np.ndarray         # (F, 4, 4) ground-truth Tcw per frame
    timestamps: np.ndarray    # (F,)
    center: np.ndarray        # (2,) turn-circle center in the xz plane
    r_inner: float            # inner wall radius
    r_outer: float            # outer wall radius
    ground_y: float           # ground plane height (y down: below camera)
    wall_top: float           # upper wall edge (min y)
    surfaces: List[_Surface]

    _ray_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_frames(self) -> int:
        return len(self.poses)

    def baseline_shift(self) -> np.ndarray:
        """Right-camera pose offset: x shifted by +baseline in camera frame."""
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -self.cam.baseline  # Tcw_right = T_rl @ Tcw_left, t = (-b, 0, 0)
        return T

    def render(self, frame: int, right: bool = False) -> np.ndarray:
        Tcw = self.poses[frame]
        if right:
            Tcw = self.baseline_shift() @ Tcw
        img, _ = self._raycast(Tcw)
        return img

    def stereo_pair(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.render(frame, False), self.render(frame, True)

    def render_depth(self, frame: int) -> np.ndarray:
        """Registered depth map of the left camera (RGB-D sensor emulation): the
        exact ray-cast camera-frame z per pixel, 0 where nothing is hit."""
        _, depth = self._raycast(self.poses[frame])
        return depth

    def rgbd_pair(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        """(gray, depth) of the left camera from ONE ray cast: the gray image is
        `render(frame)`'s, the depth `render_depth(frame)`'s."""
        return self._raycast(self.poses[frame])

    # ------------------------------------------------------------------ ray casting

    def _rays(self):
        """Per-pixel camera-frame ray directions (z=1 plane) + norms, cached."""
        key = (self.cam.width, self.cam.height)
        if key not in self._ray_cache:
            cam = self.cam
            u = np.arange(cam.width, dtype=np.float32)
            v = np.arange(cam.height, dtype=np.float32)
            dx = (u[None, :] - cam.cx) / cam.fx
            dy = (v[:, None] - cam.cy) / cam.fy
            H, W = cam.height, cam.width
            dx = np.broadcast_to(dx, (H, W)).copy()
            dy = np.broadcast_to(dy, (H, W)).copy()
            dn = np.sqrt(dx * dx + dy * dy + 1.0)
            self._ray_cache[key] = (dx, dy, dn)
        return self._ray_cache[key]

    def _raycast(self, Tcw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        cam = self.cam
        H, W = cam.height, cam.width
        Tcw = Tcw.astype(np.float32)
        R_wc = Tcw[:3, :3].T
        o = (-R_wc @ Tcw[:3, 3]).astype(np.float32)   # camera center, world
        dx, dy, dn = self._rays()
        # world-frame ray directions for camera-frame (dx, dy, 1)
        d = [R_wc[i, 0] * dx + R_wc[i, 1] * dy + R_wc[i, 2] for i in range(3)]

        best_t = np.full((H, W), np.inf, np.float32)
        img = np.full((H, W), np.float32(_BG))

        for surf in self.surfaces:
            if surf.kind == "ground":
                t, px, py, cos_inc = self._hit_ground(o, d, dn, surf)
            else:
                t, px, py, cos_inc = self._hit_cylinder(o, d, dn, surf)
            win = t < best_t
            if not win.any():
                continue
            # mip level from the texture footprint of one image pixel
            e = np.where(win, t, 1.0) * dn
            foot = e / cam.fx * surf.res / np.maximum(cos_inc, 0.05)
            level = np.clip(
                np.round(np.log2(np.maximum(foot, 1.0))), 0, _N_MIPS - 1
            ).astype(np.int32)
            shade = _sample_mips(surf.mips, px, py, level, win, surf.wrap)
            # distance fade toward background
            w = 1.0 / (1.0 + (e / _FADE_M) ** 4)
            shade = shade * w + _BG * (1.0 - w)
            img = np.where(win, shade, img)
            best_t = np.where(win, t, best_t)

        depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.uint8), depth

    def _hit_ground(self, o, d, dn, surf):
        cx, cz = surf.center if surf.center is not None else self.center
        r_lo = surf.r_lo if surf.r_lo is not None else (self.r_inner - 2.0)
        r_hi = surf.r_hi if surf.r_hi is not None else (self.r_outer + 1.0)
        dy = d[1]
        t = np.where(np.abs(dy) > 1e-9, (self.ground_y - o[1]) / np.where(
            np.abs(dy) > 1e-9, dy, 1.0), np.float32(1e12))
        hx = o[0] + t * d[0]
        hz = o[2] + t * d[2]
        rho = np.sqrt((hx - cx) ** 2 + (hz - cz) ** 2)
        ok = (t > _T_MIN) & (t < 1e11) & (rho >= r_lo) & (rho <= r_hi)
        az = np.arctan2(hz - cz, hx - cx)
        rel = np.mod(az - surf.az0, 2.0 * np.pi)
        ok &= rel <= surf.az_span
        t = np.where(ok, t, np.inf)
        px = rel * surf.radius * surf.res
        py = (rho - r_lo) * surf.res
        cos_inc = np.abs(dy) / dn
        return t, px, py, cos_inc

    def _hit_cylinder(self, o, d, dn, surf):
        cx, cz = surf.center if surf.center is not None else self.center
        ox, oz = o[0] - cx, o[2] - cz
        a = d[0] * d[0] + d[2] * d[2]
        b = 2.0 * (d[0] * ox + d[2] * oz)
        c = np.float32(ox * ox + oz * oz - surf.radius ** 2)
        disc = b * b - 4.0 * a * c
        sq = np.sqrt(np.maximum(disc, 0.0))
        a_safe = np.maximum(a, 1e-12)
        t1 = (-b - sq) / (2.0 * a_safe)
        t2 = (-b + sq) / (2.0 * a_safe)

        # wall is opaque from both sides, but an intersection in the opened
        # azimuth gap (figure-eight crossing) or outside the y band passes
        # through — so both roots are candidates, nearest VALID wins
        def _valid(t):
            ok = (disc > 0.0) & (t > _T_MIN)
            hy = o[1] + t * d[1]
            ok &= (hy >= surf.y_top) & (hy <= surf.y_bot)
            hx = o[0] + t * d[0]
            hz = o[2] + t * d[2]
            rel = np.mod(np.arctan2(hz - cz, hx - cx) - surf.az0, 2.0 * np.pi)
            return ok & (rel <= surf.az_span)

        ok1 = _valid(t1)
        t = np.where(ok1, t1, np.where(_valid(t2), t2, np.inf))
        ts = np.where(np.isfinite(t), t, 1.0)  # keep texture coords finite
        hy = o[1] + ts * d[1]
        hx = o[0] + ts * d[0]
        hz = o[2] + ts * d[2]
        az = np.arctan2(hz - cz, hx - cx)
        px = _az_to_px(az, surf)
        py = (hy - surf.y_top) * surf.res
        # incidence: radial component of the unit ray
        rad = (d[0] * (hx - cx) + d[2] * (hz - cz)) / np.float32(max(surf.radius, 1e-9))
        cos_inc = np.abs(rad) / dn
        return t, px, py, cos_inc


def _az_to_px(az: np.ndarray, surf: _Surface) -> np.ndarray:
    """Azimuth (rad, [-pi, pi]) to level-0 texture column."""
    rel = np.mod(az - surf.az0, 2.0 * np.pi)
    return rel * surf.radius * surf.res


def _sample_mips(mips, px, py, level, valid, wrap) -> np.ndarray:
    """Mip-selected bilinear texture lookup (one pass per level)."""
    out = np.zeros(px.shape, np.float32)
    for l, tex in enumerate(mips):
        m = valid & (level == l)
        if not m.any():
            continue
        s = 2.0 ** l
        mapx = (px[m] / s).astype(np.float32)
        mapy = np.clip(py[m] / s, 0, tex.shape[0] - 1.001).astype(np.float32)
        out[m] = _remap_linear(tex, mapx, mapy, wrap)
    return out


def _border_index(i: np.ndarray, n: int, wrap: bool) -> np.ndarray:
    """OpenCV borderInterpolate: BORDER_WRAP, or BORDER_REFLECT (fedcba|abcdef)."""
    if wrap:
        return np.mod(i, n)
    j = np.mod(i, 2 * n)
    return np.where(j >= n, 2 * n - 1 - j, j)


def _remap_linear(tex: np.ndarray, mapx: np.ndarray, mapy: np.ndarray, wrap: bool) -> np.ndarray:
    """cv2.remap(INTER_LINEAR) of a uint8 texture at float32 coordinates.

    Like OpenCV 5, the bilinear sum is exact and rounded to the nearest
    integer; out-of-range taps follow the border rule."""
    h, w = tex.shape
    fx = mapx.astype(np.float64)
    fy = mapy.astype(np.float64)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    ax, ay = fx - x0, fy - y0
    xa, xb = _border_index(x0, w, wrap), _border_index(x0 + 1, w, wrap)
    ya, yb = _border_index(y0, h, wrap), _border_index(y0 + 1, h, wrap)
    t = tex.astype(np.float64)
    top = (1.0 - ax) * t[ya, xa] + ax * t[ya, xb]
    bot = (1.0 - ax) * t[yb, xa] + ax * t[yb, xb]
    v = (1.0 - ay) * top + ay * bot
    return np.clip(np.rint(v), 0, 255)


def _cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of OpenCV's INTER_CUBIC resize along one axis:
    half-pixel centres, a = -0.75, edge-replicated taps."""
    scale = n_in / n_out
    fx = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    x = (fx - sx).astype(np.float32)
    A = np.float32(-0.75)
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    M = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    for k, c in enumerate((c0, c1, c2, c3)):
        np.add.at(M, (rows, np.clip(sx - 1 + k, 0, n_in - 1)), c.astype(np.float64))
    return M


def _resize_cubic(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_CUBIC) for a float32 image."""
    Mr = _cubic_matrix(img.shape[0], h)
    Mc = _cubic_matrix(img.shape[1], w)
    return (Mr @ img.astype(np.float64) @ Mc.T).astype(np.float32)


def _area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) pixel-area coverage weights of OpenCV's INTER_AREA."""
    scale = n_in / n_out
    M = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        lo, hi = d * scale, (d + 1) * scale
        for s in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
            M[d, s] = max(0.0, min(hi, s + 1) - max(lo, s))
        M[d] /= M[d].sum()
    return M


def _resize_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_AREA) for a uint8 image.
    An exact 2x reduction is the 2x2 mean rounded half up, as OpenCV does."""
    H, W = img.shape
    if H == 2 * h and W == 2 * w:
        s = img.astype(np.int32).reshape(h, 2, w, 2).sum(axis=(1, 3))
        return ((s + 2) >> 2).astype(np.uint8)
    out = _area_matrix(H, h) @ img.astype(np.float64) @ _area_matrix(W, w).T
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _fill_convex(img: np.ndarray, pts: np.ndarray, val: int) -> None:
    """Fill a convex polygon (float (n, 2) x/y vertices) the way OpenCV's
    FillConvexPoly scans it: every row between the rounded top and bottom
    vertex, from the rounded left edge to the rounded right edge, inclusive."""
    h, w = img.shape
    ys = np.arange(int(np.floor(pts[:, 1].min() + 0.5)), int(np.floor(pts[:, 1].max() + 0.5)) + 1)
    ys = ys[(ys >= 0) & (ys < h)]
    if len(ys) == 0:
        return
    yq = np.clip(ys.astype(np.float64), pts[:, 1].min(), pts[:, 1].max())
    xl = np.full(len(ys), np.inf)
    xr = np.full(len(ys), -np.inf)
    for p, q in zip(pts, np.roll(pts, -1, axis=0)):
        if p[1] == q[1]:
            on = yq == p[1]
            xl = np.where(on, np.minimum(xl, min(p[0], q[0])), xl)
            xr = np.where(on, np.maximum(xr, max(p[0], q[0])), xr)
            continue
        t = (yq - p[1]) / (q[1] - p[1])
        on = (t >= 0) & (t <= 1)
        x = p[0] + t * (q[0] - p[0])
        xl = np.where(on, np.minimum(xl, x), xl)
        xr = np.where(on, np.maximum(xr, x), xr)
    for y, a, b in zip(ys, xl, xr):
        if np.isfinite(a):
            lo = max(int(np.floor(a + 0.5)), 0)
            hi = min(int(np.floor(b + 0.5)), w - 1)
            if lo <= hi:
                img[y, lo: hi + 1] = val


def _ellipse_poly(cx: int, cy: int, ax: int, ay: int, angle: float) -> np.ndarray:
    """Vertices of cv2.ellipse's filled polygon (ellipse2Poly): the angle is
    rounded to whole degrees, vertices step by 5-90 degrees with the size."""
    a = int(np.rint(angle)) % 360
    big = max(ax, ay)
    delta = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    ca, sa = np.cos(np.deg2rad(a)), np.sin(np.deg2rad(a))
    t = np.deg2rad(np.minimum(np.arange(0, 360 + delta, delta), 360))
    x = ax * np.cos(t)
    y = ay * np.sin(t)
    return np.stack([cx + x * ca - y * sa, cy + x * sa + y * ca], axis=1)


def _box_points(cx: float, cy: float, w: float, h: float, angle: float) -> np.ndarray:
    """cv2.boxPoints(((cx, cy), (w, h), angle)) as float32 (4, 2)."""
    b = np.float32(np.cos(np.deg2rad(angle)) * 0.5)
    a = np.float32(np.sin(np.deg2rad(angle)) * 0.5)
    c = np.array([cx, cy], np.float32)
    p0 = np.array([c[0] - a * h - b * w, c[1] + b * h - a * w], np.float32)
    p1 = np.array([c[0] + a * h - b * w, c[1] - b * h - a * w], np.float32)
    return np.stack([p0, p1, 2 * c - p0, 2 * c - p1])


_WALL_WAVES = ((4, 1.0), (9, 0.9), (21, 0.8), (48, 0.7))
# Ground texture is larger-scale: a 25 cm (4 px) ground feature seen from 1.65 m
# height at 15 m range foreshortens to <2 px radially, so fine ground detail
# yields corners that alias frame-to-frame (measured 29% consecutive-frame
# descriptor survival vs 66% on walls — which destabilizes close-point tracking
# exactly like untextured real road does NOT: real close geometry is structured).
_GROUND_WAVES = ((12, 1.0), (26, 0.9), (56, 0.8), (120, 0.7))


def _make_texture(
    rng: np.random.Generator, h: int, w: int, waves=_WALL_WAVES,
    contrast: float = 1.0,
) -> List[np.ndarray]:
    """Multi-octave smoothed-noise texture + mip chain: dense FAST corners at
    every viewing scale, band-limited so resampling keeps appearance stable."""
    h = max(int(h), 8)
    w = max(int(w), 8)
    acc = np.zeros((h, w), np.float32)
    for wavelength, weight in waves:
        gh = max(2, int(np.ceil(h / wavelength)) + 1)
        gw = max(2, int(np.ceil(w / wavelength)) + 1)
        n = rng.standard_normal((gh, gw)).astype(np.float32)
        acc += weight * _resize_cubic(n, w, h)
    lo = np.percentile(acc, 1.0)
    hi = np.percentile(acc, 99.0)
    tex = np.clip((acc - lo) / max(hi - lo, 1e-6), 0.0, 1.0) * 240.0 + 8.0
    tex = 128.0 + (tex - 128.0) * contrast
    tex = tex.astype(np.uint8)
    # Sparse DISTINCTIVE structures on top of the stationary noise: random
    # high-contrast rotated bars/ellipses (the synthetic analogue of windows,
    # signs, posts). Pure multi-octave noise is statistically identical
    # everywhere, so although projection-gated tracking works, appearance-only
    # association (BoW relocalization/loop candidates, ungated descriptor
    # matching) degenerates: measured 0/67 geometrically-consistent BoW matches
    # between views 6 m apart. Real imagery — the reference's KITTI input —
    # is globally distinctive; these stamps restore that property.
    n_stamps = max((h * w) // 6000, 4)
    for _ in range(n_stamps):
        cx = rng.integers(0, w)
        cy = rng.integers(0, h)
        ax = int(rng.integers(5, 28))
        ay = int(rng.integers(3, 20))
        ang = float(rng.uniform(0, 180))
        val = int(rng.integers(0, 256))
        if rng.random() < 0.5:
            _fill_convex(tex, _ellipse_poly(int(cx), int(cy), ax, ay, ang), val)
        else:
            box = _box_points(float(cx), float(cy), 2.0 * ax, 2.0 * ay, ang)
            _fill_convex(tex, box.astype(np.int32).astype(np.float64), val)
    mips = [tex]
    for _ in range(_N_MIPS - 1):
        prev = mips[-1]
        mips.append(
            _resize_area(prev, max(prev.shape[1] // 2, 4), max(prev.shape[0] // 2, 4))
        )
    return mips


def make_world(
    num_frames: int = 100,
    cam: CameraConfig | None = None,
    seed: int = 0,
    speed: float = 1.0,
    yaw_rate: float = 0.002,
    num_landmarks: int = 6000,   # kept for API compatibility; texture worlds
    #                              have continuous surface detail instead
    # 10 m: KITTI-like street (building faces ~8-15 m from the camera). Close
    # stereo points (depth < bf*35/fx ~ 18.8 m) then cover a stable wall band;
    # at 14 m the close set is too thin and NeedNewKeyFrame's close rule
    # (tracker.cpp:1280-1284) fires every frame, flooding the map with
    # duplicate young points (measured: 39 KFs/60 frames, ATE 2.5 -> 20 KFs,
    # ATE 0.29 at 10 m).
    corridor_half_width: float = 10.0,
) -> SyntheticWorld:
    """Forward motion at constant yaw rate through a textured corridor.

    The constant-turn trajectory is a circle arc of radius 1/yaw_rate; the
    corridor walls are cylinders concentric with it (exactly parallel to the
    path), the ground an annulus — KITTI-ish geometry with exact ground truth.
    """
    del num_landmarks
    cam = cam or CameraConfig()
    rng = np.random.default_rng(seed)

    # Ground-truth camera centers along the arc; camera looks along +z
    # (world = first camera frame), y down.
    poses = []
    yaw = 0.0
    center = np.zeros(3)
    ts = []
    centers = []
    for f in range(num_frames):
        R_wc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ center
        poses.append(T)
        centers.append(center.copy())
        ts.append(f / cam.fps)
        center = center + R_wc @ np.array([0.0, 0.0, speed])
        yaw += yaw_rate * speed
    poses = np.stack(poses)
    centers = np.stack(centers)

    # Turn-circle geometry: pos(yaw) = C + R * [-cos(yaw), 0, sin(yaw)],
    # C = (R, 0, 0) for the initial heading +z at the origin.
    yaw_rate = max(abs(yaw_rate), 1e-5)   # straight line = huge-radius arc
    R_path = 1.0 / yaw_rate
    circle_center = np.array([R_path, 0.0])
    hw = corridor_half_width
    r_inner = max(R_path - hw, 2.0)
    r_outer = R_path + hw
    ground_y = 1.65
    wall_top = -8.0          # outer wall height (9.65 m, building-like)
    inner_top = -80.0        # inner wall is a tall canyon face: nothing sees
    #                          over it into the ill-defined circle interior

    # Texture strips cover the azimuth range the path traverses (+ margin);
    # full-circle paths wrap.
    az = np.unwrap(np.arctan2(centers[:, 2] - circle_center[1],
                              centers[:, 0] - circle_center[0]))
    margin = (40.0 + 30.0) / R_path
    az_lo = float(az.min() - margin)
    az_hi = float(az.max() + margin)
    span = min(az_hi - az_lo, 2.0 * np.pi)
    wrap = span >= 2.0 * np.pi - 1e-9
    if wrap:
        # Anchor the wrapped strip's origin at the START azimuth, not at
        # min(az) (= the num_frames-dependent trajectory END on these
        # decreasing-azimuth arcs): worlds with the same seed and geometry
        # then share the exact texture regardless of num_frames, so a longer
        # run is a strict prefix-extension of a shorter one (tests rely on
        # this to reason about perturbations like blackouts).
        az_lo = float(az[0] - span)

    wall_res = 16.0    # texture px per meter
    ground_res = 16.0
    ground_h = (r_outer - r_inner + 4.0) * ground_res

    surfaces = [
        _Surface(
            kind="cyl", radius=r_inner,
            mips=_make_texture(rng, (ground_y - inner_top) * wall_res,
                               span * r_inner * wall_res),
            res=wall_res, az0=az_lo, wrap=wrap, y_top=inner_top, y_bot=ground_y,
        ),
        _Surface(
            kind="cyl", radius=r_outer,
            mips=_make_texture(rng, (ground_y - wall_top) * wall_res,
                               span * r_outer * wall_res),
            res=wall_res, az0=az_lo, wrap=wrap, y_top=wall_top, y_bot=ground_y,
        ),
        _Surface(
            kind="ground", radius=R_path,
            # low-contrast like real road surface: grazing-angle BRIEF patches
            # are not viewpoint-stable, so a feature-dense ground would feed the
            # tracker unstable close points no real sequence produces
            mips=_make_texture(rng, ground_h, span * R_path * ground_res,
                               waves=_GROUND_WAVES, contrast=0.30),
            res=ground_res, az0=az_lo, wrap=wrap,
        ),
    ]

    return SyntheticWorld(
        cam=cam,
        poses=poses.astype(np.float32),
        timestamps=np.asarray(ts),
        center=circle_center,
        r_inner=r_inner,
        r_outer=r_outer,
        ground_y=ground_y,
        wall_top=wall_top,
        surfaces=surfaces,
    )


def make_figure_eight_world(
    cam: CameraConfig | None = None,
    seed: int = 0,
    speed: float = 1.0,
    lap_frames: int = 200,
    num_frames: int | None = None,
    corridor_half_width: float = 7.0,
) -> SyntheticWorld:
    """Figure-eight circuit: one lap around circle A (+yaw), one around the
    tangent circle B (-yaw), then back onto A — producing TWO spatially
    distinct loop-closure sites (the A-lap revisit near the crossing, then
    the B-lap return to it after ~lap_frames of disjoint travel). Walls are
    opened in an azimuth gap where the other corridor passes through the
    crossing, like a road intersection. The reference's equivalent would be
    a KITTI sequence with several revisits (e.g. seq 00)."""
    cam = cam or CameraConfig()
    rng = np.random.default_rng(seed)
    if num_frames is None:
        num_frames = 2 * lap_frames + lap_frames // 4

    w = 2.0 * np.pi / lap_frames  # yaw per unit arc length at speed 1
    hw = corridor_half_width
    R_path = 1.0 / w
    cA = np.array([R_path, 0.0])    # +yaw circle center (x, z)
    cB = np.array([-R_path, 0.0])   # -yaw circle center

    poses, ts = [], []
    yaw = 0.0
    yaw_lap = 0.0
    sgn = 1.0
    center = np.zeros(3)
    for f in range(num_frames):
        R_wc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ center
        poses.append(T)
        ts.append(f / cam.fps)
        center = center + R_wc @ np.array([0.0, 0.0, speed])
        yaw += sgn * w * speed
        yaw_lap += w * speed
        if yaw_lap >= 2.0 * np.pi - 1e-9:   # back at the crossing: switch circles
            yaw_lap -= 2.0 * np.pi
            sgn = -sgn

    ground_y = 1.65
    wall_top = -8.0
    inner_top = -80.0
    wall_res = 16.0
    ground_res = 16.0

    def _gap_interval(c_self, c_other, radius):
        """Azimuth interval (around c_self) of the wall circle covered by the
        OTHER corridor band — the stretch to leave open."""
        th = np.linspace(-np.pi, np.pi, 4096)
        P = c_self[None, :] + radius * np.stack([np.cos(th), np.sin(th)], 1)
        rho = np.linalg.norm(P - c_other[None, :], axis=1)
        blocked = np.abs(rho - R_path) < hw + 1.0
        if not blocked.any():
            return None
        # contiguous interval around the crossing azimuth (toward the other
        # center); rotate so it is contiguous in th
        th_t = np.arctan2(c_other[1] - c_self[1], c_other[0] - c_self[0])
        rel = np.mod(th - th_t + np.pi, 2.0 * np.pi) - np.pi
        half = np.abs(rel[blocked]).max()
        return th_t - half, th_t + half

    surfaces = []
    for c_self, c_other in ((cA, cB), (cB, cA)):
        r_in = max(R_path - hw, 2.0)
        r_out = R_path + hw
        for radius, y_top in ((r_in, inner_top), (r_out, wall_top)):
            gap = _gap_interval(c_self, c_other, radius)
            if gap is None:
                az0, span = -np.pi, 2.0 * np.pi
                wrap = True
            else:
                az0 = gap[1]                       # strip starts after the gap
                span = 2.0 * np.pi - (gap[1] - gap[0])
                wrap = False
            surfaces.append(
                _Surface(
                    kind="cyl", radius=radius,
                    mips=_make_texture(rng, (ground_y - y_top) * wall_res,
                                       span * radius * wall_res),
                    res=wall_res, az0=az0, wrap=wrap,
                    y_top=y_top, y_bot=ground_y,
                    center=(float(c_self[0]), float(c_self[1])),
                    az_span=span,
                )
            )
        ground_h = (r_out - r_in + 4.0) * ground_res
        surfaces.append(
            _Surface(
                kind="ground", radius=R_path,
                mips=_make_texture(rng, ground_h, 2.0 * np.pi * R_path * ground_res,
                                   waves=_GROUND_WAVES, contrast=0.30),
                res=ground_res, az0=-np.pi, wrap=True,
                center=(float(c_self[0]), float(c_self[1])),
                r_lo=r_in - 2.0, r_hi=r_out + 1.0,
            )
        )

    return SyntheticWorld(
        cam=cam,
        poses=np.stack(poses).astype(np.float32),
        timestamps=np.asarray(ts),
        center=cA,
        r_inner=max(R_path - hw, 2.0),
        r_outer=R_path + hw,
        ground_y=ground_y,
        wall_top=wall_top,
        surfaces=surfaces,
    )

"""The drive's world, made on the device from the seed.

A copy of the port's corridor generator (`slam_framework_torch/io/synthetic.py`,
`make_world`): a camera on a constant-yaw arc between two cylindrical walls
concentric with it, over a ground annulus, each surface a multi-octave noise
texture with sparse high-contrast stamps and a mip chain; frames are ray cast
with mip-selected bilinear lookups and a distance fade. The geometry, the ray
caster and the mip lookup follow the port's arithmetic, in float32 throughout
(the port mixes in float64 in places: 0.2% of pixels part by one level); the
textures follow its recipe but are drawn with a
`torch.Generator` on the device, in a few large calls, so a world is made in
about a second where the host recipe takes minutes at this length. Texture
sizes are rounded up to a multiple of 8 so that every mip is an exact 2x2
mean. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

BG = 90.0          # sky / beyond-fade intensity
T_MIN = 0.5        # nearest render distance (camera-frame z, metres)
N_MIPS = 4
FADE_M = 150.0     # distance fade
WALL_RES = 16.0    # texture px per metre
GROUND_RES = 16.0
GROUND_Y = 1.65    # ground height (y down)
WALL_TOP = -8.0    # outer wall's upper edge
INNER_TOP = -80.0  # the inner wall is a tall canyon face
WALL_WAVES = ((4, 1.0), (9, 0.9), (21, 0.8), (48, 0.7))
GROUND_WAVES = ((12, 1.0), (26, 0.9), (56, 0.8), (120, 0.7))
STAMP_REACH = 35   # half-size of the patch that holds one stamp (ceil(hypot(28, 20)))


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    fps: float
    bf: float

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @staticmethod
    def from_config(spec: dict) -> "Camera":
        c = spec["camera"]
        return Camera(float(c["fx"]), float(c["fy"]), float(c["cx"]), float(c["cy"]),
                      int(c["width"]), int(c["height"]), float(c["fps"]), float(c["bf"]))


@dataclasses.dataclass
class Surface:
    kind: str                   # "cyl" | "ground"
    radius: float
    mips: List[torch.Tensor]    # uint8 (h, w) each, level 0 first
    res: float
    az0: float
    wrap: bool
    y_top: float = 0.0
    y_bot: float = 0.0
    az_span: float = 2.0 * math.pi
    r_lo: Optional[float] = None
    r_hi: Optional[float] = None


@dataclasses.dataclass
class World:
    cam: Camera
    poses: np.ndarray           # (F, 4, 4) float32 ground-truth Tcw
    timestamps: np.ndarray      # (F,)
    center: Tuple[float, float]  # turn-circle centre (x, z)
    r_inner: float
    r_outer: float
    ground_y: float
    surfaces: List[Surface]

    @property
    def num_frames(self) -> int:
        return len(self.poses)

    def right_poses(self, poses: np.ndarray) -> np.ndarray:
        """Right-camera Tcw: the left's shifted by the baseline along x."""
        shift = np.eye(4, dtype=np.float32)
        shift[0, 3] = -self.cam.baseline
        return (shift @ poses).astype(np.float32)


def arc_poses(num_frames: int, speed: float, yaw_rate: float, fps: float):
    """Ground-truth Tcw along a constant-yaw arc (world = first camera frame,
    +z ahead, y down), the timestamps, and the camera centres."""
    poses, centers = [], []
    yaw = 0.0
    center = np.zeros(3)
    for _ in range(num_frames):
        R_wc = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R_wc.T
        T[:3, 3] = -R_wc.T @ center
        poses.append(T)
        centers.append(center.copy())
        center = center + R_wc @ np.array([0.0, 0.0, speed])
        yaw += yaw_rate * speed
    ts = np.arange(num_frames) / fps
    return np.stack(poses).astype(np.float32), ts, np.stack(centers)


def _cubic_taps(n_in: int, n_out: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """OpenCV INTER_CUBIC along one axis: (4, n_out) source indices
    (edge-replicated) and weights, half-pixel centres, a = -0.75."""
    scale = n_in / n_out
    fx = (torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) * scale - 0.5
    sx = torch.floor(fx)
    x = fx - sx
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    sx = sx.long()
    idx = torch.stack([(sx - 1 + k).clamp(0, n_in - 1) for k in range(4)])
    return idx, torch.stack([c0, c1, c2, c3])


def _resize_cubic(img: torch.Tensor, w: int, h: int) -> torch.Tensor:
    ic, wc = _cubic_taps(img.shape[1], w, img.device)
    tmp = sum(img[:, ic[k]] * wc[k][None, :] for k in range(4))
    ir, wr = _cubic_taps(img.shape[0], h, img.device)
    return sum(tmp[ir[k], :] * wr[k][:, None] for k in range(4))


def _percentiles(x: torch.Tensor, qs) -> torch.Tensor:
    """Percentiles of a large tensor from an even subsample of at most 2**22."""
    flat = x.reshape(-1)
    step = max(1, -(-flat.numel() // (1 << 22)))
    return torch.quantile(flat[::step], torch.tensor(qs, device=x.device, dtype=x.dtype))


def _stamp(tex: torch.Tensor, gen: torch.Generator, batch: int = 1024) -> None:
    """Sparse distinctive structures over the noise (the recipe's windows,
    signs and posts): filled rotated ellipses and boxes of random value, the
    later stamp over the earlier, clipped at the strip's edges."""
    h, w = tex.shape
    dev = tex.device
    n = max((h * w) // 6000, 4)
    cx = torch.randint(0, w, (n,), generator=gen, device=dev)
    cy = torch.randint(0, h, (n,), generator=gen, device=dev)
    ax = torch.randint(5, 28, (n,), generator=gen, device=dev).float()
    ay = torch.randint(3, 20, (n,), generator=gen, device=dev).float()
    ang = torch.rand(n, generator=gen, device=dev) * math.pi
    val = torch.randint(0, 256, (n,), generator=gen, device=dev).to(torch.uint8)
    ellipse = torch.rand(n, generator=gen, device=dev) < 0.5
    r = torch.arange(-STAMP_REACH, STAMP_REACH + 1, device=dev)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    oy, ox = oy.reshape(1, -1), ox.reshape(1, -1)
    owner = torch.full((h * w,), -1, dtype=torch.long, device=dev)
    for lo in range(0, n, batch):
        s = slice(lo, min(lo + batch, n))
        ca, sa = torch.cos(ang[s])[:, None], torch.sin(ang[s])[:, None]
        u = ox * ca + oy * sa
        v = -ox * sa + oy * ca
        a, b = ax[s][:, None], ay[s][:, None]
        inside = torch.where(ellipse[s][:, None], (u / a) ** 2 + (v / b) ** 2 <= 1.0,
                             (u.abs() <= a) & (v.abs() <= b))
        px = cx[s][:, None] + ox
        py = cy[s][:, None] + oy
        inside &= (px >= 0) & (px < w) & (py >= 0) & (py < h)
        ids = torch.arange(lo, s.stop, device=dev)[:, None].expand_as(inside)
        owner.scatter_reduce_(0, (py * w + px)[inside], ids[inside], "amax")
    hit = owner >= 0
    flat = tex.view(-1)
    flat[hit] = val[owner[hit]]


def make_texture(gen: torch.Generator, h: float, w: float, device, waves=WALL_WAVES,
                 contrast: float = 1.0) -> List[torch.Tensor]:
    """Multi-octave smoothed-noise texture with stamps, and its mip chain."""
    h = -(-max(int(h), 8) // 8) * 8
    w = -(-max(int(w), 8) // 8) * 8
    acc = torch.zeros((h, w), dtype=torch.float32, device=device)
    for wavelength, weight in waves:
        gh = max(2, math.ceil(h / wavelength) + 1)
        gw = max(2, math.ceil(w / wavelength) + 1)
        noise = torch.randn((gh, gw), generator=gen, device=device)
        acc += weight * _resize_cubic(noise, w, h)
    lo, hi = _percentiles(acc, [0.01, 0.99]).tolist()
    tex = torch.clamp((acc - lo) / max(hi - lo, 1e-6), 0.0, 1.0) * 240.0 + 8.0
    tex = (128.0 + (tex - 128.0) * contrast).to(torch.uint8)
    del acc
    _stamp(tex, gen)
    mips = [tex]
    for _ in range(N_MIPS - 1):
        prev = mips[-1].to(torch.int32)
        s = prev[0::2, 0::2] + prev[1::2, 0::2] + prev[0::2, 1::2] + prev[1::2, 1::2]
        mips.append(((s + 2) >> 2).to(torch.uint8))
    return mips


def make_world(seed: int, num_frames: int, cam: Camera, device, speed: float = 1.0,
               yaw_rate: float = 0.002, corridor_half_width: float = 10.0) -> World:
    """Forward motion at a constant yaw rate through a textured corridor
    (`make_world` of the port): walls concentric with the arc, over a ground
    annulus; the strips cover the azimuths the path crosses, with a margin,
    and wrap when the path is a full circle."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    poses, ts, centers = arc_poses(num_frames, speed, yaw_rate, cam.fps)
    yaw_rate = max(abs(yaw_rate), 1e-5)
    R_path = 1.0 / yaw_rate
    circle = (R_path, 0.0)
    hw = corridor_half_width
    r_inner = max(R_path - hw, 2.0)
    r_outer = R_path + hw
    az = np.unwrap(np.arctan2(centers[:, 2] - circle[1], centers[:, 0] - circle[0]))
    margin = (40.0 + 30.0) / R_path
    az_lo = float(az.min() - margin)
    az_hi = float(az.max() + margin)
    span = min(az_hi - az_lo, 2.0 * math.pi)
    wrap = span >= 2.0 * math.pi - 1e-9
    if wrap:
        az_lo = float(az[0] - span)
    ground_h = (r_outer - r_inner + 4.0) * GROUND_RES
    surfaces = [
        Surface("cyl", r_inner, make_texture(gen, (GROUND_Y - INNER_TOP) * WALL_RES, span * r_inner * WALL_RES,
                                             device), WALL_RES, az_lo, wrap, y_top=INNER_TOP, y_bot=GROUND_Y),
        Surface("cyl", r_outer, make_texture(gen, (GROUND_Y - WALL_TOP) * WALL_RES, span * r_outer * WALL_RES,
                                             device), WALL_RES, az_lo, wrap, y_top=WALL_TOP, y_bot=GROUND_Y),
        Surface("ground", R_path, make_texture(gen, ground_h, span * R_path * GROUND_RES, device,
                                               waves=GROUND_WAVES, contrast=0.30), GROUND_RES, az_lo, wrap),
    ]
    return World(cam, poses, ts, circle, r_inner, r_outer, GROUND_Y, surfaces)


# ---------------------------------------------------------------------- ray casting


def _rays(cam: Camera, device):
    u = torch.arange(cam.width, dtype=torch.float32, device=device)
    v = torch.arange(cam.height, dtype=torch.float32, device=device)
    dx = ((u[None, :] - cam.cx) / cam.fx).expand(cam.height, cam.width)
    dy = ((v[:, None] - cam.cy) / cam.fy).expand(cam.height, cam.width)
    dn = torch.sqrt(dx * dx + dy * dy + 1.0)
    return dx, dy, dn


def _hit_ground(world: World, surf: Surface, o, d, dn):
    cx, cz = world.center
    r_lo = surf.r_lo if surf.r_lo is not None else world.r_inner - 2.0
    r_hi = surf.r_hi if surf.r_hi is not None else world.r_outer + 1.0
    dy = d[1]
    ok_dy = dy.abs() > 1e-9
    t = torch.where(ok_dy, (world.ground_y - o[1]) / torch.where(ok_dy, dy, torch.ones_like(dy)),
                    torch.full_like(dy, 1e12))
    hx = o[0] + t * d[0]
    hz = o[2] + t * d[2]
    rho = torch.sqrt((hx - cx) ** 2 + (hz - cz) ** 2)
    ok = (t > T_MIN) & (t < 1e11) & (rho >= r_lo) & (rho <= r_hi)
    rel = torch.remainder(torch.atan2(hz - cz, hx - cx) - surf.az0, 2.0 * math.pi)
    ok &= rel <= surf.az_span
    t = torch.where(ok, t, torch.full_like(t, math.inf))
    return t, rel * surf.radius * surf.res, (rho - r_lo) * surf.res, dy.abs() / dn


def _hit_cylinder(world: World, surf: Surface, o, d, dn):
    cx, cz = world.center
    ox, oz = o[0] - cx, o[2] - cz
    a = d[0] * d[0] + d[2] * d[2]
    b = 2.0 * (d[0] * ox + d[2] * oz)
    c = ox * ox + oz * oz - surf.radius ** 2
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    a_safe = a.clamp_min(1e-12)
    t1 = (-b - sq) / (2.0 * a_safe)
    t2 = (-b + sq) / (2.0 * a_safe)

    def valid(t):
        ok = (disc > 0.0) & (t > T_MIN)
        hy = o[1] + t * d[1]
        ok &= (hy >= surf.y_top) & (hy <= surf.y_bot)
        rel = torch.remainder(torch.atan2(o[2] + t * d[2] - cz, o[0] + t * d[0] - cx) - surf.az0, 2.0 * math.pi)
        return ok & (rel <= surf.az_span)

    inf = torch.full_like(t1, math.inf)
    t = torch.where(valid(t1), t1, torch.where(valid(t2), t2, inf))
    ts = torch.where(torch.isfinite(t), t, torch.ones_like(t))
    hy = o[1] + ts * d[1]
    hx = o[0] + ts * d[0]
    hz = o[2] + ts * d[2]
    px = torch.remainder(torch.atan2(hz - cz, hx - cx) - surf.az0, 2.0 * math.pi) * surf.radius * surf.res
    py = (hy - surf.y_top) * surf.res
    rad = (d[0] * (hx - cx) + d[2] * (hz - cz)) / max(surf.radius, 1e-9)
    return t, px, py, rad.abs() / dn


def _border(i: torch.Tensor, n: int, wrap: bool) -> torch.Tensor:
    """OpenCV borderInterpolate: BORDER_WRAP, or BORDER_REFLECT."""
    if wrap:
        return torch.remainder(i, n)
    j = torch.remainder(i, 2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


def _remap_linear(tex: torch.Tensor, mapx: torch.Tensor, mapy: torch.Tensor, wrap: bool) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR) of a uint8 texture at float32 coordinates,
    the bilinear sum exact and rounded to the nearest integer."""
    h, w = tex.shape
    fx, fy = mapx, mapy
    x0, y0 = torch.floor(fx), torch.floor(fy)
    ax, ay = fx - x0, fy - y0
    x0, y0 = x0.long(), y0.long()
    xa, xb = _border(x0, w, wrap), _border(x0 + 1, w, wrap)
    ya, yb = _border(y0, h, wrap), _border(y0 + 1, h, wrap)
    flat = tex.reshape(-1)

    def tap(y, x):
        return flat[y * w + x].float()

    top = (1.0 - ax) * tap(ya, xa) + ax * tap(ya, xb)
    bot = (1.0 - ax) * tap(yb, xa) + ax * tap(yb, xb)
    return torch.clamp(torch.round((1.0 - ay) * top + ay * bot), 0, 255)


def _sample_mips(mips, px, py, level, valid, wrap) -> torch.Tensor:
    out = torch.zeros(px.shape, dtype=torch.float32, device=px.device)
    for lvl, tex in enumerate(mips):
        m = valid & (level == lvl)
        s = 2.0 ** lvl
        mapx = (px[m] / s).float()
        mapy = torch.clamp(py[m] / s, 0, tex.shape[0] - 1.001).float()
        out[m] = _remap_linear(tex, mapx, mapy, wrap)
    return out


def render(world: World, poses: np.ndarray, device) -> torch.Tensor:
    """(B, H, W) uint8 images of the given (B, 4, 4) Tcw, on `device`."""
    cam = world.cam
    Tcw = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    R_wc = Tcw[:, :3, :3].transpose(1, 2)
    o_all = -(R_wc @ Tcw[:, :3, 3:4])[..., 0]                       # (B, 3) float32
    dx, dy, dn = _rays(cam, device)
    R = R_wc
    d = [R[:, i, 0, None, None] * dx + R[:, i, 1, None, None] * dy + R[:, i, 2, None, None] for i in range(3)]
    o = [o_all[:, i, None, None] for i in range(3)]
    shape = d[0].shape
    best_t = torch.full(shape, math.inf, dtype=torch.float32, device=device)
    img = torch.full(shape, BG, dtype=torch.float32, device=device)
    for surf in world.surfaces:
        hit = _hit_ground if surf.kind == "ground" else _hit_cylinder
        t, px, py, cos_inc = hit(world, surf, o, d, dn)
        win = t < best_t
        e = torch.where(win, t, torch.ones_like(t)) * dn
        foot = e / cam.fx * surf.res / cos_inc.clamp_min(0.05)
        level = torch.clamp(torch.round(torch.log2(foot.clamp_min(1.0))), 0, N_MIPS - 1).long()
        shade = _sample_mips(surf.mips, px, py, level, win, surf.wrap)
        wgt = 1.0 / (1.0 + (e / FADE_M) ** 4)
        shade = shade * wgt + BG * (1.0 - wgt)
        img = torch.where(win, shade, img)
        best_t = torch.where(win, t, best_t)
    return torch.clamp(img, 0, 255).to(torch.uint8)

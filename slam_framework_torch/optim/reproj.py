"""Reprojection Jacobian rows in structure-of-arrays layout.

Port of slam_framework_tpu/optim/reproj.py, which pose optimization and local
bundle adjustment share. Every Jacobian row entry is an (M,) tensor
(observation index last); pose optimization's normal-equation sums are formed
as one (n, M) x (M, n) product per residual row instead of the reference's 21
scalar reductions, which changes only the order of the fp32 sums.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from slam_framework_torch.geometry.projection import Intrinsics


def camera_rows(x, y, z, K: Intrinsics):
    """Jacobian rows wrt the left-multiplied camera twist (omega, upsilon) of the
    residual meas - pred, for u, v and ur. x, y, z: (M,) camera-frame coords.
    Returns (du, dv, dur) — each a list of 6 (M,) tensors — and inv_z."""
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    inv_z2 = inv_z * inv_z
    xz = x * inv_z
    yz = y * inv_z
    zeros = torch.zeros_like(z)
    du = [K.fx * (xz * yz), -K.fx * (1.0 + xz * xz), K.fx * yz, -K.fx * inv_z, zeros, K.fx * x * inv_z2]
    dv = [K.fy * (1.0 + yz * yz), -K.fy * (xz * yz), -K.fy * xz, zeros, -K.fy * inv_z, K.fy * y * inv_z2]
    # ur = u - bf/z; dz/d omega = (y, -x, 0), dz/d upsilon = (0, 0, 1)
    dz = [yz * z, -xz * z, zeros, zeros, zeros, torch.ones_like(z)]
    dur = [du[i] - K.bf * inv_z2 * dz[i] for i in range(6)]
    return du, dv, dur, inv_z


def point_rows(x, y, z, R_cols, K: Intrinsics):
    """Jacobian rows wrt the world point: J_row = -dproj_row . R.

    R_cols: the observing camera's rotation entries per observation, ((M,),) * 9
    in row-major order [R00..R22]. Returns (pu, pv, pur), each a list of 3 (M,)
    tensors."""
    inv_z = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    inv_z2 = inv_z * inv_z
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = R_cols
    # dproj rows (d pred / d Xc): u: (fx/z, 0, -fx x/z^2); v: (0, fy/z, -fy y/z^2)
    au, cu = K.fx * inv_z, -K.fx * x * inv_z2
    bv, cv = K.fy * inv_z, -K.fy * y * inv_z2
    pu = [-(au * R00 + cu * R20), -(au * R01 + cu * R21), -(au * R02 + cu * R22)]
    pv = [-(bv * R10 + cv * R20), -(bv * R11 + cv * R21), -(bv * R12 + cv * R22)]
    # the ur row adds bf/z^2 * dz/dXw = bf/z^2 * R row 2
    cz = K.bf * inv_z2
    pur = [pu[k] - cz * (R20, R21, R22)[k] for k in range(3)]
    return pu, pv, pur


def sym_outer_sum(rows_w: Sequence[Tuple[Sequence[torch.Tensor], torch.Tensor]], n: int) -> torch.Tensor:
    """H = sum over (rows, w) of sum_m w_m row_m row_m^T. Returns (n, n)."""
    H = None
    for rows, w in rows_w:
        J = torch.stack(list(rows)[:n])  # (n, M)
        term = torch.matmul(J * w, J.T)
        H = term if H is None else H + term
    return H


def rhs_sum(rows_w_r: Sequence[Tuple[Sequence[torch.Tensor], torch.Tensor, torch.Tensor]], n: int) -> torch.Tensor:
    """b = sum over (rows, w, r) of sum_m w_m r_m row_m. Returns (n,)."""
    b = None
    for rows, w, r in rows_w_r:
        term = torch.matmul(torch.stack(list(rows)[:n]), w * r)
        b = term if b is None else b + term
    return b

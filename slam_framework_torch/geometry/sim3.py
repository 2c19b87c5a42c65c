"""Sim3 (similarity transform) operations for loop closing and the pose graph.

Port of slam_framework_tpu/geometry/sim3.py. A Sim3 is a dict of tensors
{'R': (..., 3, 3), 't': (..., 3), 's': (...,)} with any leading batch
dimensions; its action on a point is x -> s * R @ x + t. The exp/log maps use
the 7-vector (omega, upsilon, sigma): rotation, translation, log-scale.

Every branch that a `torch.where` does not select is still evaluated, and a
forward-mode derivative runs through it too, so each one is computed on a safe
argument (clamped denominators, as in the reference): the tangents of exp and
log are finite at the identity, where the pose graph's edges sit once a graph
is consistent. `log` solves its 3x3 system in closed form, so nothing here
reads a value back to the host.
"""

from __future__ import annotations

import torch

from slam_framework_torch.geometry import se3

_EPS = 1e-8


def make(R: torch.Tensor, t: torch.Tensor, s) -> dict:
    return {"R": R, "t": t, "s": torch.as_tensor(s, dtype=R.dtype, device=R.device)}


def identity(batch_shape=(), dtype=torch.float32, device=None) -> dict:
    batch_shape = tuple(batch_shape)
    return {
        "R": torch.eye(3, dtype=dtype, device=device).expand(batch_shape + (3, 3)),
        "t": torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
        "s": torch.ones(batch_shape, dtype=dtype, device=device),
    }


def apply(S: dict, pts: torch.Tensor) -> torch.Tensor:
    """Action on (..., N, 3) points: s*R@x + t."""
    return S["s"][..., None, None] * torch.einsum("...ij,...nj->...ni", S["R"], pts) + S["t"][..., None, :]


def compose(A: dict, B: dict) -> dict:
    """A after B: (A*B)(x) = A(B(x))."""
    return {
        "R": torch.matmul(A["R"], B["R"]),
        "t": A["s"][..., None] * torch.einsum("...ij,...j->...i", A["R"], B["t"]) + A["t"],
        "s": A["s"] * B["s"],
    }


def inverse(S: dict) -> dict:
    Rt = S["R"].transpose(-1, -2)
    inv_s = 1.0 / torch.clamp(S["s"], min=_EPS)
    return {
        "R": Rt,
        "t": -inv_s[..., None] * torch.einsum("...ij,...j->...i", Rt, S["t"]),
        "s": inv_s,
    }


def from_se3(T: torch.Tensor) -> dict:
    R, t = se3.mat_to_rt(T)
    return {"R": R, "t": t, "s": torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)}


def to_se3(S: dict) -> torch.Tensor:
    """Project to SE3 by folding the scale into the translation: [R | t/s], the
    correction applied to keyframe poses after the essential-graph optimisation
    (optimizer.cpp:925-940)."""
    return se3.rt_to_mat(S["R"], S["t"] / torch.clamp(S["s"][..., None], min=_EPS))


def _w_matrix(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The W matrix of the Sim3 exponential (the SO3 left Jacobian generalised
    by the scale; coefficients per Strasdat's thesis, Taylor forms for small
    sigma / theta): exp((w, u, sigma)) has translation W @ u."""
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = se3.hat(w)
    W2 = torch.matmul(W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta < 1e-5
    one = torch.ones_like(sigma)
    sig2 = sigma * sigma

    A_ss = torch.where(small_sigma, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / torch.where(small_sigma, one, sigma))
    sig2t2 = torch.clamp(sig2 + theta2, min=_EPS)
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    A_gen = (a * sigma + (1.0 - b) * theta) / torch.clamp(theta * sig2t2, min=_EPS)
    B_gen = (A_ss - ((b - 1.0) * sigma + a * theta) / sig2t2) / torch.clamp(theta2, min=_EPS)
    A_st = torch.where(
        small_sigma,
        0.5 + sigma / 6.0,
        ((sigma - 1.0) * s + 1.0) / torch.where(small_sigma, one, torch.clamp(sig2, min=_EPS)),
    )
    B_st = torch.where(
        small_sigma,
        1.0 / 6.0 + sigma / 24.0,
        ((0.5 * sig2 - sigma + 1.0) * s - 1.0) / torch.where(small_sigma, one, torch.clamp(sig2 * sigma, min=_EPS)),
    )
    A = torch.where(small_theta, A_st, A_gen)
    B = torch.where(small_theta, B_st, B_gen)
    return A_ss[..., None, None] * eye + A[..., None, None] * W + B[..., None, None] * W2


def exp(v: torch.Tensor) -> dict:
    """Sim3 exponential: (..., 7) = (omega, upsilon, sigma) -> Sim3."""
    w, u, sigma = v[..., :3], v[..., 3:6], v[..., 6]
    t = torch.einsum("...ij,...j->...i", _w_matrix(w, sigma), u)
    return {"R": se3.so3_exp(w), "t": t, "s": torch.exp(sigma)}


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of A x = b for (..., 3, 3) systems by Cramer's rule (W is I + O(|w|),
    never near singular): elementwise, no pivoting, no status read back."""
    c0, c1, c2 = A[..., :, 0], A[..., :, 1], A[..., :, 2]
    c12 = torch.linalg.cross(c1, c2, dim=-1)
    det = torch.sum(c0 * c12, dim=-1)
    x0 = torch.sum(b * c12, dim=-1)
    x1 = torch.sum(c0 * torch.linalg.cross(b, c2, dim=-1), dim=-1)
    x2 = torch.sum(c0 * torch.linalg.cross(c1, b, dim=-1), dim=-1)
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def log(S: dict) -> torch.Tensor:
    """Sim3 logarithm: Sim3 -> (..., 7); the inverse of `exp` (W u = t solved for u)."""
    w = se3.so3_log(S["R"])
    sigma = torch.log(torch.clamp(S["s"], min=_EPS))
    u = _solve3(_w_matrix(w, sigma), S["t"])
    return torch.cat([w, u, sigma[..., None]], dim=-1)

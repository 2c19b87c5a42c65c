"""Huber robust-kernel weighting (g2o RobustKernelHuber semantics).

Port of slam_framework_tpu/optim/robust.py.
"""

from __future__ import annotations

import torch

CHI2_MONO = 5.991    # 95% quantile, chi^2 2-dof
CHI2_STEREO = 7.815  # 95% quantile, chi^2 3-dof


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight for the Huber kernel given squared error chi2 and delta^2:
    1 inside, delta / sqrt(chi2) outside."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / safe))

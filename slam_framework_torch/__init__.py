"""PyTorch/CUDA port of the stereo SLAM engine in `slam_framework_tpu`.

The JAX package beside this one is the reference: every module here mirrors the
module of the same path there, and the tests under `tests/test_torch_*.py` run
the same inputs through both. This package imports torch, numpy and scipy only;
it never imports jax, cv2 or `slam_framework_tpu`, and reads no file of that
package: it keeps its own copies of the ORB sampling pattern
(`ops/orb_pattern.npy`) and of the arena's native C++ source
(`csrc/arena_ops.cpp`).

Numerics: the reference pins fp32 `Precision.HIGHEST` for every matrix product
(its `utils/precision.py`). PyTorch keeps fp32 matmuls in full precision by
default but lets cuDNN use TF32, so both switches are pinned off here.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
# Kernels and the native arena library are compiled here at first use.
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the first
    CUDA device. A missing GPU never selects the CPU: with no device named and
    no CUDA device present this raises, and the CPU is taken only when the
    caller passes it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was given; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", 0)

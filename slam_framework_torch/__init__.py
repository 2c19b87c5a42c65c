"""PyTorch/CUDA port of the stereo SLAM engine in `slam_framework_tpu`.

The JAX package beside this one is the reference: every module here mirrors the
module of the same path there, and the tests under `tests/test_torch_*.py` run
the same inputs through both. This package imports torch, numpy and scipy only;
it never imports jax, cv2 or `slam_framework_tpu`. Data files of the reference
(the ORB sampling pattern, the arena's native C++ source) are read by path.

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
# The JAX package's data files (read by path, never imported).
REFERENCE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "slam_framework_tpu")
# Kernels and the native arena library are compiled here at first use.
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")

"""Fused FAST-9 strength + 3x3 NMS: wrapper of the CUDA kernel csrc/fast_nms.cu.

Replaces the Pallas TPU kernel `slam_framework_tpu/ops/fast_pallas.py`
(`fast_nms_strength`). Computes `fast.nms3x3(fast.fast_strength_map(imgs))`
bit for bit on the whole image. Bound by device memory: ~8 bytes per pixel,
~5 MB per 1241x376 stereo frame over all pyramid levels; the kernel keeps the
16 circle differences in registers and the tile in shared memory, so each
pixel is read and written once (see the source's header).

The library is compiled with nvcc for sm_90a at first use into
`slam_framework_torch/build/`, keyed on the source's hash, and bound with ctypes.
A CPU tensor takes the plain version in ops/fast.py; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from slam_framework_torch import BUILD_DIR, PACKAGE_DIR
from slam_framework_torch.ops import fast

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "fast_nms.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches since the count was last set to 0 (plain-version calls on
# CPU tensors do not count).
launches = 0

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the FAST+NMS kernel cannot be built")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfast_nms_{digest}.so")


def build() -> str:
    """Compile the kernel library if it is not built yet; returns its path."""
    so = library_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.fast_nms_strength_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def fast_nms_strength_plain(imgs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, (..., H, W) fp32."""
    return fast.nms3x3(fast.fast_strength_map(imgs))


def fast_nms_strength(imgs: torch.Tensor) -> torch.Tensor:
    """NMS'd FAST-9 strength maps: (B, H, W) or (H, W) fp32 -> same shape."""
    if imgs.device.type == "cpu":
        return fast_nms_strength_plain(imgs)
    if imgs.device.type != "cuda":
        raise ValueError(f"fast_nms_strength: unsupported device {imgs.device}")
    if imgs.dtype != torch.float32:
        raise TypeError(f"fast_nms_strength: expected float32, got {imgs.dtype}")
    if imgs.dim() not in (2, 3):
        raise ValueError(f"fast_nms_strength: expected (B, H, W) or (H, W), got {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("fast_nms_strength: input must be contiguous")
    batch = imgs if imgs.dim() == 3 else imgs[None]
    B, H, W = batch.shape
    if B > 65535:
        raise ValueError(f"fast_nms_strength: batch {B} exceeds the grid's z limit")
    lib = _load()
    out = torch.empty_like(batch)
    with torch.cuda.device(batch.device):
        stream = torch.cuda.current_stream(batch.device).cuda_stream
        err = lib.fast_nms_strength_launch(batch.data_ptr(), out.data_ptr(), B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"fast_nms_strength: kernel launch failed (cudaError {err})")
    global launches
    launches += 1
    return out if imgs.dim() == 3 else out[0]

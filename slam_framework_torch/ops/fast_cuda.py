"""Fused FAST-9 strength + 3x3 NMS: wrapper of the CUDA kernel csrc/fast_nms.cu.

Replaces the Pallas TPU kernel `slam_framework_tpu/ops/fast_pallas.py`
(`fast_nms_strength`). Computes `fast.nms3x3(fast.fast_strength_map(img))`
bit for bit on the whole image, for every image of a list in ONE launch: the
front-end hands it the 16 level images of a stereo frame's two pyramids.

Per 1241x376 stereo frame the 8 levels of both images hold 2 x 1,444,097 =
2,888,194 pixels: 23.1 MB read and written (6.9 us at 3.35 TB/s) and 103 fp32
operations per pixel (8.9 us at the card's fp32 rate), so the arithmetic, not
memory, is the bound; the source's header says what the kernel does about it.

The grid is a flat list of TILE_H x TILE_W tiles over all images. `tile_table`
lays it out on the host; the table goes to the kernel by value with each call.

The library is compiled with nvcc for sm_90a at first use into
`slam_framework_torch/build/`, keyed on the source's hash and the flags, and
bound with ctypes. A CPU tensor takes the plain version in ops/fast.py; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from slam_framework_torch import BUILD_DIR, PACKAGE_DIR
from slam_framework_torch.ops import fast

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "fast_nms.cu")

# Tile geometry, handed to the source as macros: a block of WARPS warps, each
# writing 30 columns (32 lanes less one NMS halo column per side), walks TILE_H rows.
WARPS = 4
TILE_H = 24
TILE_W = 30 * WARPS
MAX_IMAGES = 32  # entries of the kernel's by-value table; longer lists take more launches

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC",
              f"-DFAST_NMS_WARPS={WARPS}", f"-DFAST_NMS_TILE_H={TILE_H}"]

# The function's work per pixel, for the bound: one fp32 read and one written;
# 2 subtractions + 94 arc min/max + 1 max for the strength, 4 max + 1 compare +
# 1 select for the NMS (the count of the source's header).
BYTES_PER_PIXEL = 8
OPS_PER_PIXEL = 103

# One record per image, as the kernel's `Image` struct (32 bytes, no padding).
IMAGE_DTYPE = np.dtype([("src", "<u8"), ("dst", "<u8"), ("height", "<i4"), ("width", "<i4"),
                        ("tiles_x", "<i4"), ("first_tile", "<i4")])
# Each image's maps start on a 128-byte boundary of the one output buffer.
_ALIGN = 32

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
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def tile_table(shapes: Sequence[Tuple[int, int]]) -> Tuple[np.ndarray, int]:
    """The kernel's table for images of the given (H, W), pointers left 0, and
    the grid size. Image i owns the tiles first_tile[i] .. first_tile[i+1]-1 of
    the flat grid, row-major over ceil(H / TILE_H) x ceil(W / TILE_W) tiles."""
    table = np.zeros(len(shapes), IMAGE_DTYPE)
    n_tiles = 0
    for i, (h, w) in enumerate(shapes):
        tiles_x = -(-w // TILE_W)
        table[i] = (0, 0, h, w, tiles_x, n_tiles)
        n_tiles += tiles_x * -(-h // TILE_H)
    return table, n_tiles


@functools.lru_cache(maxsize=64)
def _plan(shapes: Tuple[Tuple[int, int], ...]):
    """Per tuple of shapes: the tables (one per launch of at most MAX_IMAGES
    images) and each image's offset in the one output buffer, in floats."""
    chunks = [tile_table(shapes[i:i + MAX_IMAGES]) for i in range(0, len(shapes), MAX_IMAGES)]
    sizes = np.array([h * w for h, w in shapes], np.int64)
    padded = -(-sizes // _ALIGN) * _ALIGN
    offsets = np.concatenate([[0], np.cumsum(padded)[:-1]])
    return chunks, offsets, int(offsets[-1] + sizes[-1])


def _launch_all(chunks, src_ptrs: np.ndarray, dst_ptrs: np.ndarray, device: torch.device) -> None:
    """One launch per table of `chunks` (see _plan) on the device's current stream."""
    global launches
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for k, (template, n_tiles) in enumerate(chunks):
            table = template.copy()  # the cached template is shared between callers
            lo = k * MAX_IMAGES
            table["src"] = src_ptrs[lo:lo + len(table)]
            table["dst"] = dst_ptrs[lo:lo + len(table)]
            # the launcher copies the records into the kernel's parameter before it returns
            err = lib.fast_nms_strength_launch(table.ctypes.data, len(table), n_tiles, stream)
            if err != 0:
                raise RuntimeError(f"fast_nms_strength: kernel launch failed (cudaError {err})")
            launches += 1


def _check_cuda_input(t: torch.Tensor, dims: Tuple[int, ...]) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"fast_nms_strength: expected float32, got {t.dtype}")
    if t.dim() not in dims:
        raise ValueError(f"fast_nms_strength: expected {' or '.join(str(d) for d in dims)} "
                         f"dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("fast_nms_strength: input must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"fast_nms_strength: empty input {tuple(t.shape)}")


def fast_nms_strength_plain(imgs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, (..., H, W) fp32."""
    return fast.nms3x3(fast.fast_strength_map(imgs))


def fast_nms_strength_levels(levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """NMS'd FAST-9 strength maps of images of different (H, W), all fp32,
    contiguous and on one device: one kernel launch for up to 32 images. The
    maps are views of one buffer."""
    levels = list(levels)
    if not levels:
        return []
    device = levels[0].device
    if any(t.device != device for t in levels):
        raise ValueError("fast_nms_strength: the images lie on different devices")
    if device.type == "cpu":
        return [fast_nms_strength_plain(t) for t in levels]
    if device.type != "cuda":
        raise ValueError(f"fast_nms_strength: unsupported device {device}")
    for t in levels:
        _check_cuda_input(t, (2,))
    shapes = tuple((t.shape[0], t.shape[1]) for t in levels)
    chunks, offsets, total = _plan(shapes)
    out = torch.empty(total, dtype=torch.float32, device=device)
    src = np.array([t.data_ptr() for t in levels], np.uint64)
    _launch_all(chunks, src, np.uint64(out.data_ptr()) + offsets.astype(np.uint64) * np.uint64(4), device)
    return [out.as_strided((h, w), (w, 1), o) for o, (h, w) in zip(offsets.tolist(), shapes)]


def fast_nms_strength(imgs: torch.Tensor) -> torch.Tensor:
    """NMS'd FAST-9 strength maps: (B, H, W) or (H, W) fp32 -> same shape."""
    if imgs.device.type == "cpu":
        return fast_nms_strength_plain(imgs)
    if imgs.device.type != "cuda":
        raise ValueError(f"fast_nms_strength: unsupported device {imgs.device}")
    _check_cuda_input(imgs, (2, 3))
    B = 1 if imgs.dim() == 2 else imgs.shape[0]
    H, W = imgs.shape[-2:]
    out = torch.empty_like(imgs)
    step = np.arange(B, dtype=np.uint64) * np.uint64(4 * H * W)
    _launch_all(_plan(((H, W),) * B)[0], np.uint64(imgs.data_ptr()) + step, np.uint64(out.data_ptr()) + step,
                imgs.device)
    return out

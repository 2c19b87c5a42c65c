"""PNG reader without cv2: the standard library's zlib and struct, plus the row
unfilter in C++ (csrc/png_unfilter.cpp, built with g++ at first use).

It stands in for `cv2.imread` where the port reads a dataset (io/kitti.py, the
TUM-style RGB-D runner) and gives what OpenCV 5 (libpng 1.6) gives:

  - `imread_gray(path)` is `cv2.imread(path, cv2.IMREAD_GRAYSCALE)`: alpha is
    dropped, 16-bit samples keep their high byte, and colour goes through
    libpng's `png_set_rgb_to_gray` with OpenCV's weights 0.299 / 0.587:
    `(9797 R + 19234 G + 3737 B) >> 15`, truncated, for 8-bit samples and
    `(... + 16384) >> 15` before the high byte for 16-bit ones. (This is not
    `cvtColor`'s rounded 14-bit formula.)
  - `imread_unchanged(path)` is `cv2.imread(path, cv2.IMREAD_UNCHANGED)`: grey
    as (H, W) uint8 or native-endian uint16 (a depth map), colour as BGR /
    BGRA, grey with alpha as BGRA.

Scope: non-interlaced files of colour type 0 (grey), 2 (RGB), 4 (grey +
alpha) and 6 (RGBA) at bit depth 8 or 16, which is what KITTI and TUM ship.
Interlaced (Adam7) and palette files, other bit depths and damaged files raise
ValueError naming the file. A missing file raises FileNotFoundError. If the
unfilter routine cannot be built, that raises too: there is no Python
fallback, which would take ~0.5 s per KITTI image.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

from slam_framework_torch import PACKAGE_DIR
from slam_framework_torch.native import compile_host_library

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "png_unfilter.cpp")
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel
_LOCK = threading.Lock()
_LIB = None


def _unfilter_lib() -> ctypes.CDLL:
    """The compiled unfilter routine (built on the first call; a failed build raises)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = compile_host_library(SOURCE)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.png_unfilter.restype = ctypes.c_int64
            lib.png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, u8p]
            _LIB = lib
        return _LIB


def _read_chunks(path: str, data: bytes):
    """(IHDR fields, concatenated IDAT payload) of a PNG file's bytes."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG ({kind!r} chunk)")
        body = data[pos + 8: end]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end: end + 4])[0]:
            raise ValueError(f"{path}: damaged {kind!r} chunk")
        pos = end + 4
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    return ihdr, b"".join(idat)


def _decode(path: str) -> np.ndarray:
    """The file's samples as (H, W, C) in file order (grey, GA, RGB, RGBA):
    uint8, or native-endian uint16 at bit depth 16."""
    with open(path, "rb") as f:
        data = f.read()
    (width, height, depth, colour, compression, filt, interlace), payload = _read_chunks(path, data)
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNG files are not supported")
    if colour == 3:
        raise ValueError(f"{path}: palette PNG files are not supported")
    if colour not in _CHANNELS or depth not in (8, 16) or compression != 0 or filt != 0:
        raise ValueError(f"{path}: unsupported PNG (colour type {colour}, bit depth {depth})")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    row_bytes = width * bpp
    try:
        raw = zlib.decompress(payload)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if len(raw) < height * (row_bytes + 1):
        raise ValueError(f"{path}: image data ends early")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(height * row_bytes, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bad = _unfilter_lib().png_unfilter(src.ctypes.data_as(u8p), height, row_bytes, bpp, out.ctypes.data_as(u8p))
    if bad:
        raise ValueError(f"{path}: unknown filter type on row {bad - 1}")
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    return out.reshape(height, width, channels)


def _rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's png_set_rgb_to_gray at OpenCV's weights, then 16 -> 8 bits by
    dropping the low byte."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    s = 9797 * r + 19234 * g + 3737 * b
    if rgb.dtype == np.uint16:
        return (((s + 16384) >> 15) >> 8).astype(np.uint8)
    return (s >> 15).astype(np.uint8)


def imread_gray(path: str) -> np.ndarray:
    """(H, W) uint8, as `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` gives it."""
    px = _decode(path)
    if px.shape[2] >= 3:
        return _rgb_to_gray(px[..., :3])
    gray = px[..., 0]
    return (gray >> 8).astype(np.uint8) if gray.dtype == np.uint16 else gray.copy()


def imread_unchanged(path: str) -> np.ndarray:
    """The file's own samples, as `cv2.imread(path, cv2.IMREAD_UNCHANGED)`
    gives them: (H, W) for grey, BGR or BGRA for colour, BGRA for grey +
    alpha; uint8, or native-endian uint16 at bit depth 16."""
    px = _decode(path)
    c = px.shape[2]
    if c == 1:
        return px[..., 0].copy()
    if c == 2:
        return np.ascontiguousarray(px[..., [0, 0, 0, 1]])
    return np.ascontiguousarray(px[..., [2, 1, 0, 3][:c]])

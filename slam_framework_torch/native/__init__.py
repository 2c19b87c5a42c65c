"""The arena's native host loops (csrc/arena_ops.cpp), via ctypes, and the
g++ route that builds this package's host C++ sources.

The C++ source is this package's copy of the reference package's
native/arena_ops.cpp; it is compiled with g++ at first use into this package's
build directory, keyed on the source's and the flags' hash. The flags name no
host CPU (no -march=native), so a build directory carried to another machine
holds nothing that machine cannot run. When no compiler works, `load_arena_ops` returns None and the
arena takes its numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from slam_framework_torch import BUILD_DIR, PACKAGE_DIR

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "arena_ops.cpp")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False
CXXFLAGS = ("-O3", "-shared", "-fPIC")


def library_path(source: str) -> str:
    """Where the library built from `source` lives: named after the source and
    the hash of its text and of the compiler flags."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def compile_host_library(source: str) -> ctypes.CDLL:
    """Compile one C++ source of csrc/ with g++ into the build directory (once:
    the file name carries the source's and the flags' hash) and load it. Raises OSError or
    subprocess.CalledProcessError when it cannot be built or loaded."""
    so = library_path(source)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", *CXXFLAGS, source, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def load_arena_ops():
    """Return the ctypes library (compiling on first call) or None on failure."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = compile_host_library(SOURCE)
        except (OSError, subprocess.CalledProcessError):
            return None

        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32, i64 = ctypes.c_int32, ctypes.c_int64

        lib.register_observations.restype = i64
        lib.register_observations.argtypes = [i32, i32p, i64, i32p, i32p, i32p, i64]
        lib.erase_keyframe_observations.restype = None
        lib.erase_keyframe_observations.argtypes = [i32, i32p, i64, i32p, i32p, i32p, i64]
        lib.covisibility_counts.restype = None
        lib.covisibility_counts.argtypes = [i32, i32p, i64, i32p, i32p, i64, i64p, i64]
        lib.merge_points.restype = i32
        lib.merge_points.argtypes = [
            i32, i32, i32p, i64, i32p, i32p, i32p, i32p, i32p, u8p, i64,
        ]
        _LIB = lib
        return _LIB


def as_i32p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def as_i64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def as_u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

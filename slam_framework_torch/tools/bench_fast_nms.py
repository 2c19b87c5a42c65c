"""Times the FAST+NMS kernel at the 16 level shapes of a 1241x376 stereo frame.

    python -m slam_framework_torch.tools.bench_fast_nms [--parent DIR] [--geometry 4x32,4x16]

Needs one NVIDIA GPU and nvcc. Prints the card's name and power limit, then for
each version the device time of one whole stereo frame (16 images; CUDA graph
of 50 frames between two events, L2 warm, and with the L2 flushed before every
frame), the per-level device times, the host time of the frame's wrapper calls
(host clock, device not waited for) and the time between two events around the
eager calls. Every version is held against the plain version with torch.equal
before it is timed.

--parent DIR names a checkout of another commit of this repository (say
`git archive <commit> | tar -x -C DIR`): its kernel is built from its own
source and timed in turns with this tree's (parent, this, this, parent) in the
one process, on the one card. A parent without `fast_nms_strength_levels` is
called as its front-end called it: once per level image.

--geometry lists WARPSxTILE_H variants of this tree's source to time as well.

--report prints what the compiler made of this tree's kernel first: ptxas's
registers, shared memory and spills, and the SASS opcode counts (cuobjdump).

The last line is one JSON object with every number printed.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np


def _frame_levels(torch, device):
    """The 16 level images of a random 0..255 stereo pair at the default geometry."""
    from slam_framework_torch.config import SlamConfig
    from slam_framework_torch.ops import pyramid

    cfg = SlamConfig()
    rng = np.random.default_rng(0)
    pair = rng.integers(0, 256, (2, cfg.camera.height, cfg.camera.width)).astype(np.float32)
    levels = []
    for img in torch.from_numpy(pair).to(device):
        levels += pyramid.build_pyramid(img.contiguous(), cfg.orb.num_levels, cfg.orb.scale_factor)
    return levels


def _load_parent(directory: str):
    """The parent checkout's wrapper module, building from the parent's source."""
    path = os.path.join(directory, "slam_framework_torch", "ops", "fast_cuda.py")
    spec = importlib.util.spec_from_file_location("parent_fast_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = os.path.join(directory, "slam_framework_torch", "csrc", "fast_nms.cu")
    return mod


def _frame_call(mod, levels):
    if hasattr(mod, "fast_nms_strength_levels"):
        return lambda: mod.fast_nms_strength_levels(levels)
    return lambda: [mod.fast_nms_strength(t) for t in levels]


def _set_geometry(mod, warps: int, tile_h: int) -> None:
    """Rebuild this tree's kernel with another tile geometry."""
    mod.WARPS, mod.TILE_H, mod.TILE_W = warps, tile_h, 30 * warps
    mod.NVCC_FLAGS = [f for f in mod.NVCC_FLAGS if not f.startswith("-DFAST_NMS_")]
    mod.NVCC_FLAGS += [f"-DFAST_NMS_WARPS={warps}", f"-DFAST_NMS_TILE_H={tile_h}"]
    mod._lib = None
    mod._plan.cache_clear()


def _compiler_report(mod) -> None:
    """ptxas's resource lines and the SASS opcode histogram of mod's kernel."""
    nvcc = mod._nvcc()
    os.makedirs(mod.BUILD_DIR, exist_ok=True)
    so = os.path.join(mod.BUILD_DIR, f"report_{os.getpid()}.so")
    try:
        out = subprocess.run([nvcc, *mod.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, mod.SOURCE],
                             capture_output=True, text=True, check=True)
        for line in (out.stdout + out.stderr).splitlines():
            if "Used" in line or "spill" in line:
                print("ptxas:", line.strip(), flush=True)
        cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
        if os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True).stdout
            ops = collections.Counter(
                m.group(1) for m in re.finditer(r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sass, re.M))
            print("sass:", ", ".join(f"{op} {n}" for op, n in ops.most_common(14)), flush=True)
    finally:
        if os.path.exists(so):
            os.remove(so)


def _measure(torch, timing, name, mod, levels, want, flush, per_level: bool) -> dict:
    call = _frame_call(mod, levels)
    got = call()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise SystemExit(f"FAIL: {name} differs from the plain version at {tuple(w.shape)}")
    res = {
        "name": name,
        "device_ms": timing.device_ms(call),
        "device_flushed_ms": timing.device_ms_flushed(call, flush),
        "host_ms": timing.host_ms(call),
        "event_ms": timing.event_ms(call),
    }
    if per_level:
        res["level_us"] = [
            timing.device_ms(_frame_call(mod, [t])) * 1e3 for t in levels[: len(levels) // 2]
        ]
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of another commit to time in turns with this tree")
    ap.add_argument("--geometry", default="", help="comma-separated WARPSxTILE_H variants to time")
    ap.add_argument("--report", action="store_true", help="print ptxas and SASS figures of this tree's kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    from slam_framework_torch.ops import fast_cuda
    from slam_framework_torch.utils import cuda_timing as timing

    print(timing.card_line(), flush=True)
    if args.report:
        _compiler_report(fast_cuda)
    device = torch.device("cuda", 0)
    levels = _frame_levels(torch, device)
    want = [fast_cuda.fast_nms_strength_plain(t) for t in levels]
    flush = timing.l2_flusher(device)
    pixels = sum(t.numel() for t in levels)
    bound, by = timing.bound_ms(pixels * fast_cuda.BYTES_PER_PIXEL, pixels * fast_cuda.OPS_PER_PIXEL)
    print(f"{len(levels)} images, {pixels} pixels, bound {bound:.5f} ms by {by}", flush=True)

    runs = []
    this = ("this", fast_cuda)
    order = [this]
    if args.parent:
        parent = ("parent", _load_parent(args.parent))
        order = [parent, this, this, parent]
    for name, mod in order:
        runs.append(_measure(torch, timing, name, mod, levels, want, flush, per_level=True))
    for geo in filter(None, args.geometry.split(",")):
        warps, tile_h = (int(v) for v in geo.split("x"))
        _set_geometry(fast_cuda, warps, tile_h)
        runs.append(_measure(torch, timing, f"this {geo}", fast_cuda, levels, want, flush, per_level=False))
    plain = timing.device_ms(lambda: [fast_cuda.fast_nms_strength_plain(t) for t in levels], calls=5)
    print(json.dumps({"card": timing.card_line(), "pixels": pixels, "bound_ms": bound, "bound_by": by,
                      "plain_device_ms": plain, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

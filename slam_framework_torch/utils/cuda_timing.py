"""Timing of work on one CUDA device, and the least time the card could take.

Device time is read from CUDA events around the replay of a CUDA graph that
holds `calls` copies of the work, so the host's launch latency (which for a
small kernel exceeds the kernel) is not in the figure. Host time is the host
clock around the call alone, without waiting for the device: what a
host-bound caller pays to enqueue it.

Every function here needs a CUDA device; none falls back to the CPU.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch

# NVIDIA H100 SXM, published peaks (data sheet; they assume the 700 W limit).
H100_BYTES_PER_S = 3.35e12
# 67 TFLOP/s of fp32 outside the tensor cores counts a fused multiply-add as
# two; an add, min, max or compare fills the same lane for one result.
H100_FP32_SIMPLE_OPS_PER_S = 67e12 / 2


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for n_bytes of memory traffic and n_ops simple fp32
    operations on an H100, in ms, and which of the two sets it."""
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = n_ops / H100_FP32_SIMPLE_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_ms(fn: Callable[[], object], calls: int = 50, replays: int = 5,
              between: Callable[[], object] | None = None) -> float:
    """Median device time of one fn() in ms: `calls` copies captured in one
    CUDA graph, replayed `replays` times between two events. `between` runs
    before every copy (to flush the L2, say) and is in the figure."""
    fn()
    if between is not None:
        between()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            if between is not None:
                between()
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def l2_flusher(device: torch.device, n_bytes: int = 256 << 20) -> Callable[[], object]:
    """A call that overwrites n_bytes (several times the 50 MB L2) on the device."""
    buf = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    return buf.zero_


def device_ms_flushed(fn: Callable[[], object], flush: Callable[[], object], calls: int = 20) -> float:
    """Device time of fn() when it finds the L2 cold: (flush + fn) less flush alone."""
    return device_ms(fn, calls, between=flush) - device_ms(flush, calls)


def host_ms(fn: Callable[[], object], reps: int = 200) -> float:
    """Median host time of one fn() in ms: the host clock around the call,
    the device not waited for (it is drained every 20 calls, outside the clock)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times)


def event_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Median time in ms between two events around ONE eager fn(): the host's
    launch latency where that exceeds the device's work."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)

"""One run of one cell: set-up, the measured window, the check.

Set-up makes the traffic from the seed with the mix's generator (the world
and its frames), builds the program's system as the configuration states it,
and tracks the mix's pre-roll untimed (the map matures, the pipeline reaches
its depth, every shape the window uses has run). The window then hands in
each frame when the generator's feed has it there (in a closed loop, as soon
as the previous call returns), for `seconds`, on the host clock
(`slambench/clock.py`). After it the loop goes on, untimed, until every frame
handed in during the window has come back, so each has its natural latency;
then the system is shut down, the device's peak memory read, the program
freed, and the outputs are judged against the plain reference
(`slambench/check.py`).

With `trace`, a stretch of whole chunks inside the window runs under the
profiler (`slambench/trace.py`) and the per-layer readers report; the stage
timers the readers take cover the whole window.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import resource
import sys
import time
import types
from typing import Callable, Dict, Optional

import numpy as np
import torch

from slambench import check, clock, manifest, roofline
from slambench import trace as tracing
from slambench.manifest import load_json

TRACE_AFTER_S = 10.0   # the stretch opens at the first chunk boundary this far into the window
TRACE_CHUNKS = 6       # whole chunks under the profiler
FAST_SAMPLES = 4       # frames of the window whose FAST+NMS maps are compared


def slam_config(config_file: str, spec: dict):
    """The program's configuration as the file states it: the program reads
    the upstream JSON schema from the file itself, and the capacities are the
    file's `capacity` block."""
    from slam_framework_torch.config import CapacityConfig, SlamConfig

    cfg = SlamConfig.from_json(config_file, sensor=spec["sensor"])
    return dataclasses.replace(cfg, capacity=CapacityConfig(**spec["capacity"]))


def _timers(timers) -> Dict[str, float]:
    return dict(timers.total_s)


def _read_first(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def host_sample() -> Dict[str, float]:
    """What the host gave this process, read from /proc and the cgroup: its
    CPU seconds and context switches, the machine's stolen CPU time, the
    cgroup's throttling and the cores' mean clock. Differences of two samples
    say whether a slow window lost its host to others."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"wall_s": time.perf_counter(), "cpu_user_s": ru.ru_utime, "cpu_sys_s": ru.ru_stime,
           "ctx_involuntary": float(ru.ru_nivcsw), "ctx_voluntary": float(ru.ru_nvcsw),
           "load_1m": os.getloadavg()[0]}
    stat = _read_first("/proc/stat").split("\n", 1)[0].split()
    if len(stat) > 8:
        out["steal_s"] = int(stat[8]) / os.sysconf("SC_CLK_TCK")
    for line in _read_first("/sys/fs/cgroup/cpu.stat").splitlines():
        key, _, value = line.partition(" ")
        if key in ("nr_throttled", "throttled_usec", "usage_usec"):
            out[f"cgroup_{key}"] = float(value)
    mhz = [float(line.split(":")[1]) for line in _read_first("/proc/cpuinfo").splitlines()
           if line.startswith("cpu MHz")]
    if mhz:
        out["cpu_mhz_mean"] = sum(mhz) / len(mhz)
    return out


def host_delta(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """The second sample less the first, for the counters; the clock and the
    load as read at the end."""
    return {k: (b[k] if k in ("cpu_mhz_mean", "load_1m") else b[k] - a[k]) for k in b if k in a}


def run_cell(config_file: str, mix: dict, limits: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, readers: Optional[Dict[str, Callable]] = None, tf32: bool = False,
             fault: Optional[Callable] = None, log=None) -> dict:
    """Run one cell and return what it measured and what the check found.

    `device` is the first CUDA device unless given (the tests run the
    harness on the CPU at a small size). `tf32` lets the program's float32
    matrix products run in TF32: the lower-precision control. `fault(system)`
    breaks the timed path underneath as the window opens (tests and the
    calibration only)."""
    from slam_framework_torch.ops import fast_cuda
    from slam_framework_torch.system import SlamSystem

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device) if device is not None else torch.device("cuda", 0)
    on_card = device.type == "cuda"
    tf32_was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        spec = load_json(config_file)
        cfg = slam_config(config_file, spec)
        sync, depth = int(spec["sync_every"]), int(spec["pipeline_depth"])
        t_drive = time.perf_counter()
        traffic = manifest.load_generator(mix["generator"])(mix, spec, seed, seconds, sync * (depth + 1), device)
        t_system = time.perf_counter()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        system = SlamSystem(cfg, sync_every=sync, device=device,
                            place_recognition=bool(spec["place_recognition"]))
        tracker = system.tracker
        tracker.pipeline_depth = depth
        P = traffic.preroll
        entry = getattr(system, spec["entry"])
        n = traffic.n_frames
        ts = traffic.timestamps
        start = np.zeros(n)
        end = np.zeros(n)
        arrival = np.zeros(n)
        n_rec = np.zeros(n, np.int64)

        def call(f: int) -> None:
            start[f] = time.perf_counter()
            entry(*traffic.frame(f), float(ts[f]))
            end[f] = time.perf_counter()
            n_rec[f] = len(tracker.records)

        t_preroll = time.perf_counter()
        for f in range(P):
            call(f)
        if on_card:
            torch.cuda.synchronize()
        t_setup = time.perf_counter()
        setup_s = t_setup - t_start
        setup_parts = {"to_harness_s": t_drive - t_start, "world_and_frames_s": t_system - t_drive,
                       "system_s": t_preroll - t_system, "preroll_s": t_setup - t_preroll}
        kfs_at_open = system.arena.n_valid_kfs
        depth_at_open = tracker._current_depth()

        # ------------------------------------------------------------ window
        if fault is not None:
            fault(system)
        recorder = check.FastRecorder(np.random.default_rng([int(seed) % (1 << 63), 7]), P, FAST_SAMPLES)
        recorder.install(tracker, fast_cuda)
        stretch = tracing.Stretch(min(TRACE_AFTER_S, seconds / 5), TRACE_CHUNKS) if trace else None
        timers0, events0 = _timers(tracker.timers), len(tracker.metrics.records)
        host0 = host_sample()
        f = P
        t_open = time.perf_counter()
        ran_out = False
        while True:
            if f >= n:
                ran_out = True
                break
            now = time.perf_counter()
            if f > P and now - t_open >= seconds:
                break
            due = traffic.due_s(f - P)
            if due is not None and now < t_open + due:
                time.sleep(t_open + due - now)
            before = len(tracker.records)
            call(f)
            arrival[f] = start[f] if due is None else min(start[f], t_open + due)
            if stretch is not None:
                stretch.on_call(end[f] - t_open, len(tracker.records) > before)
            f += 1
        hi = f
        recorder.active = False
        if stretch is not None:
            stretch.close()
        host = host_delta(host0, host_sample())
        timers1, events1 = _timers(tracker.timers), len(tracker.metrics.records)
        if ran_out:
            log(f"the window ran out of frames: all {n} rendered frames were handed in "
                f"{end[hi - 1] - t_open:.3f} s into a {seconds} s window; the window ends there")

        # ------------------------------------------------------------ after the window
        # at most the rendered tail: a pipeline of `depth` chunks brings every frame back within it
        tail_end = min(n, hi + sync * (depth + 1))
        while f < tail_end and system.tracker is tracker and len(tracker.records) < hi:
            call(f)
            arrival[f] = start[f]
            f += 1
        t_trace = time.perf_counter()
        trace_data = stretch.data() if stretch is not None else None
        trace_read_s = time.perf_counter() - t_trace
        keyframes = sum(1 for r in tracker.metrics.records[events0:events1] if r.get("event") == "keyframe")
        timer_s = {k: v - timers0.get(k, 0.0) for k, v in timers1.items()}
        recorder.uninstall()

        records = list(tracker.records)
        same_tracker = system.tracker is tracker
        holding = clock.first_calls_holding(n_rec[:f], len(records))
        returned = np.full(n, -1, np.int64)
        lost = np.zeros(n, bool)
        est = {}
        for j, r in enumerate(records):
            if 0 <= r.frame_id < n:
                returned[r.frame_id] = holding[j]
                lost[r.frame_id] = bool(r.lost)
                if r.pose is not None and not r.lost:
                    est[int(r.frame_id)] = np.asarray(r.pose, np.float64)
        win = clock.window(start, end, returned, lost, P, hi, arrival=arrival)
        # the tail outside the profiled stretch, which slows the host that sets the pace
        traced = None if trace_data is None else (stretch.t_open, stretch.t_close)
        untraced = clock.window(start, end, returned, lost, P, hi, arrival=arrival, skip=traced)

        # what a per-layer reader takes: the window's frames and keyframes, the
        # stage timers' seconds over it, the latency tail outside the traced
        # stretch, the traced stretch, the frame's pyramid pixels, and the
        # system itself for the program's own counters
        ctx = types.SimpleNamespace(
            system=system, frames=hi - P, keyframes=keyframes, timer_s=timer_s, trace=trace_data,
            latency_p95_ms=untraced["latency_p_ms"] if untraced["latency_samples"] else None,
            pyramid_pixels=roofline.pyramid_pixels(cfg.camera.height, cfg.camera.width, cfg.orb.num_levels,
                                                   cfg.orb.scale_factor, traffic.images(P).shape[0]))
        per_layer = {}
        for name, read in (readers or {}).items():
            value = read(ctx)
            if value is not None:
                per_layer[name] = value
        breakdown = trace_data.breakdown() if trace_data is not None else None

        stats = system.shutdown()
        if on_card:
            torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        arena = system.arena
        m = {k: np.array(getattr(arena, k)) for k in
             ("pt_valid", "pt_pos", "pt_first_kf", "pt_obs_kf", "kf_valid", "kf_pose", "kf_frame_id")}
        captured = recorder.to_host()
        del system, tracker, entry, recorder, ctx, records
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # ------------------------------------------------------------ the check
        t_check = time.perf_counter()
        free_scale = spec["sensor"] == "monocular"
        numbers = dict(check.pose_numbers(est, traffic.poses, range(P, hi), free_scale))
        numbers.update(check.map_numbers(m, traffic.poses, numbers["scale"] if free_scale else 1.0,
                                         traffic.surface_distance))
        numbers.update(check.fast_numbers(captured, traffic.images, cfg.orb.num_levels, cfg.orb.scale_factor))
        numbers["lost_share"] = win["failed"] / win["attempted"]
        numbers["same_tracker"] = float(same_tracker)
        checks = check.judge(numbers, limits)
        if not same_tracker:
            checks["same_tracker"] = {"value": 0.0, "limit": 1.0, "ok": False}
        check_s = time.perf_counter() - t_check
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_was

    return {
        "setup_s": setup_s, "setup_parts": setup_parts, "window": win, "ran_out": ran_out,
        "per_layer": per_layer, "breakdown": breakdown, "host": host,
        "trace": None if trace_data is None else {"busy_s": trace_data.busy_s, "window_s": trace_data.wall_s,
                                                  "read_s": trace_read_s, "frames": trace_data.frames},
        "memory_peak_bytes": int(memory_peak), "numbers": numbers, "checks": checks,
        "correct": all(c["ok"] for c in checks.values()), "check_s": check_s,
        "keyframes_in_window": keyframes, "kfs_at_open": kfs_at_open, "depth_at_open": depth_at_open,
        "stats": {k: stats[k] for k in ("frames", "keyframes", "map_points", "loops_closed", "resets")},
        "n_frames": n, "preroll": P, "window_frames": hi - P,
    }

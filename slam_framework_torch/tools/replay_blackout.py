"""Replay the stretch after the blackout of the bench world on the card and on
the CPU from one state, and each device program of it on both from the same
inputs.

    python -m slam_framework_torch.tools.replay_blackout [--snapshot 100] [--end 150] [--no-landing] [--out FILE]

The world and configuration are those of `chip_smoke.py`'s phase 7: the bench
world at `SlamConfig()` defaults, frames 110-112 a uniform gray pair,
`sync_every=8`, the tracker's default pipeline depth 2. One SlamSystem tracks
frames 0 .. snapshot-1 on the card. Then the whole system (the arena, the
tracker with its chunk in flight, its device state and block, the local
mapper with its in-flight results and keyframe store, the loop closer, the
relocalizer and their generators) is copied three times (`clone_system`):
- `card_copy`, to the card again: the control. It must stay bit-equal to the
  original `card`, or the copy misses state;
- `cpu`, to the CPU;
- `cpu_copying`, to the CPU again, run with copying conversions between numpy
  and torch (`torch.from_numpy` and `Tensor.numpy` copy, as the card's
  transfers do): it stays bit-equal to `cpu` unless the CPU run reads a host
  array through a tensor that shares its memory, or the reverse.
All four track frames snapshot .. end-1 from the same pixels. `--no-landing`
runs the local mapper's heavy stage without its first step, the landing of an
earlier keyframe's triangulation and BA (pipeline/local_mapper.py), as the
reference does: the card's run then loses tracking again after relocalizing.

Logged per system, in order: every keyframe (its frame, the points culled at
it), every local-BA launch (its cameras, the fixed ones, the points and
observations and a checksum of the point ids) and landing (observations
rejected, divergent aborts, the largest camera move and the median point move
it wrote), every triangulation and fusion landed (points made, observations
added, points merged), every keyframe culled, every relocalization attempt
(per candidate: BoW matches, RANSAC, motion-only BA and guided-retry inliers)
and every frame (lost or not, inliers).

While `card` runs, each of its device programs is run again on the CPU from
the same inputs, moved there: the front-end, the tracking core, the local
BA, triangulation and fusion, and the relocalization attempt (from a CPU copy
of the whole system taken just before it). That tells a stage that computes
differently on the card from a difference that only compounds.

Prints JSON lines: the card's name and power limit, the systems' outcomes,
the first event at which each pair of systems parts, and per program the
largest card-vs-CPU difference from the same inputs. `--out` takes the whole
record as JSON.
"""

from __future__ import annotations

import argparse
import copy
import json
import multiprocessing
import os
import time
import types

import numpy as np
import torch

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.optim import local_ba
from slam_framework_torch.pipeline.frame import StereoFrontend
from slam_framework_torch.pipeline.local_mapper import LocalMapper
from slam_framework_torch.pipeline.relocalization import Relocalizer
from slam_framework_torch.pipeline.tracker import StereoTracker
from slam_framework_torch.system import SlamSystem
from slam_framework_torch.tools.track_bench_world import bench_world, frame_pair, multi_loop_config, parse_blackout

SYNC = 8
BLACKOUT = range(110, 113)
SYSTEMS = ("card", "card_copy", "cpu", "cpu_copying")


# ---------------------------------------------------------------- the copy

_LEAVES = (np.ndarray, str, bytes, int, float, bool, type(None), torch.device, torch.dtype, type, types.ModuleType)


def _tensors_and_generators(root) -> dict:
    """id -> object for every tensor and torch.Generator reachable from root
    through attributes, slots, containers, bound methods and closures."""
    found, seen, stack = {}, set(), [root]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, (torch.Tensor, torch.Generator)):
            found[id(obj)] = obj
            continue
        if isinstance(obj, _LEAVES):
            continue
        if isinstance(obj, dict):
            stack.extend(obj.keys())
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple, set, frozenset)):
            stack.extend(obj)
        elif hasattr(obj, "__self__") and hasattr(obj, "__func__"):
            stack.append(obj.__self__)
        elif callable(obj) and getattr(obj, "__closure__", None):
            stack.extend(c.cell_contents for c in obj.__closure__)
        else:
            stack.extend(getattr(obj, "__dict__", {}).values())
            for cls in type(obj).__mro__:
                for s in getattr(cls, "__slots__", ()):
                    if hasattr(obj, s):
                        stack.append(getattr(obj, s))
    return found


def _retarget_devices(root, device: torch.device) -> None:
    """Point every `torch.device` attribute of a different type at `device`."""
    seen, stack = set(), [root]
    while stack:
        obj = stack.pop()
        if id(obj) in seen or isinstance(obj, _LEAVES + (torch.Tensor, types.FunctionType, types.MethodType)):
            continue
        seen.add(id(obj))
        if isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple, set)):
            stack.extend(obj)
        elif hasattr(obj, "__dict__"):
            for k, v in vars(obj).items():
                if isinstance(v, torch.device) and v.type != device.type:
                    setattr(obj, k, device)
                else:
                    stack.append(v)


def clone_system(system: SlamSystem, device) -> SlamSystem:
    """A copy of the whole system with every tensor moved to `device`: the same
    state, nothing shared with the original."""
    device = torch.device(device)
    memo = {}
    for i, obj in _tensors_and_generators(system).items():
        if isinstance(obj, torch.Generator):
            g = torch.Generator(device=obj.device)
            g.set_state(obj.get_state())
            memo[i] = g
        else:
            memo[i] = obj.detach().to(device, copy=True)
    new = copy.deepcopy(system, memo)
    _retarget_devices(new, device)
    closer = new.loop_closer
    if closer is not None:  # the keyframe-erase hook is a closure over its system

        def _forget(k: int) -> None:
            closer.db.erase(k)
            closer.bow_frames.pop(k, None)

        new.tracker.local_mapper.on_erase_keyframe = _forget
    return new


def drop_the_landing() -> None:
    """LocalMapper._heavy_stage without the landing: the write-backs it makes
    before its launches land nothing while it runs."""
    inner = LocalMapper._heavy_stage

    def heavy(self, kf):
        self.apply_pending_triangulation = self.flush_ba = lambda *a, **k: None
        try:
            inner(self, kf)
        finally:
            del self.apply_pending_triangulation, self.flush_ba

    LocalMapper._heavy_stage = heavy


class _CopyingConversions:
    """`torch.from_numpy` and `Tensor.numpy` copy while entered."""

    def __enter__(self):
        self._from, self._numpy = torch.from_numpy, torch.Tensor.numpy
        from_numpy, numpy = self._from, self._numpy
        torch.from_numpy = lambda a: from_numpy(a).clone()
        torch.Tensor.numpy = lambda t, *a, **k: numpy(t, *a, **k).copy()
        return self

    def __exit__(self, *exc):
        torch.from_numpy, torch.Tensor.numpy = self._from, self._numpy


# ---------------------------------------------------------------- the logs

class Recorder:
    """Per-system event logs, and the card-vs-CPU comparisons of the card's programs."""

    def __init__(self):
        self.owner = {}                       # id(tracker / mapper / relocalizer) -> system name
        self.logs = {name: [] for name in SYSTEMS}
        self.current = None                   # the system being fed
        self.systems = {}
        self.stage = {}                       # program -> list of comparisons
        self.compare = True

    def register(self, name: str, system: SlamSystem) -> None:
        self.systems[name] = system
        tracker = system.tracker
        for obj in (system, tracker, tracker.local_mapper, tracker.relocalizer):
            self.owner[id(obj)] = name

    def log(self, obj, **event) -> None:
        name = self.owner.get(id(obj))
        if name is not None:
            event["frame"] = int(self.systems[name].tracker.frame_id)
            self.logs[name].append(event)

    def comparing(self) -> bool:
        return self.compare and self.current == "card"

    def add_stage(self, program: str, **diff) -> None:
        self.stage.setdefault(program, []).append(diff)

    def guarded(self, program: str, fn) -> None:
        """Run one comparison; a failure is recorded, not raised."""
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the record says what failed
            self.add_stage(program, error=f"{type(e).__name__}: {e}")


def _np(t):
    return t.detach().cpu().numpy()


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_cpu(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    return x


def _centres(T: np.ndarray) -> np.ndarray:
    T = T.astype(np.float64)
    return -np.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])


def install(rec: Recorder) -> None:
    """Wrap the mapper's, tracker's and relocalizer's methods (class-wide) to log
    per system and, while the card runs, compare its programs with the CPU's."""
    M, T, R, F = LocalMapper, StereoTracker, Relocalizer, StereoFrontend

    def wrap(cls, name, make):
        setattr(cls, name, make(getattr(cls, name)))

    def process_keyframe(inner):
        def f(self, kf, *a, **k):
            rec.log(self, ev="keyframe", kf=int(kf), kf_frame=int(self.arena.kf_frame_id[kf]))
            return inner(self, kf, *a, **k)
        return f

    def cull_points(inner):
        def f(self, kf):
            n = int(self.arena.n_valid_pts)
            inner(self, kf)
            rec.log(self, ev="cull_points", kf=int(kf), culled=n - int(self.arena.n_valid_pts))
        return f

    def local_ba_launch(inner):
        def f(self, kf):
            n = len(self._ba_pendings)
            inner(self, kf)
            if len(self._ba_pendings) > n:
                p = self._ba_pendings[-1]
                cams = [int(c) for c in p["cams"]]
                rec.log(self, ev="ba_launch", kf=int(kf), cams=cams,
                        fixed=[int(c) for c, x in zip(cams, p["cam_fixed"]) if x],
                        points=len(p["pid_set"]), pid_checksum=int(np.asarray(p["pid_set"], np.int64).sum()),
                        obs=int(p["m"]))
        return f

    def apply_ba(inner):
        def f(self, pending, prefetched=None):
            arena = self.arena
            cams = np.asarray(pending["cams"], np.int64)
            pids = np.asarray(pending["pid_set"], np.int64)
            c0, p0 = _centres(arena.kf_pose[cams]), arena.pt_pos[pids].astype(np.float64)
            aborts = self.ba_aborts
            inner(self, pending, prefetched)
            moved_c = np.linalg.norm(_centres(arena.kf_pose[cams]) - c0, axis=1)
            moved_p = np.linalg.norm(arena.pt_pos[pids].astype(np.float64) - p0, axis=1)
            live = arena.pt_valid[pids]
            rec.log(self, ev="ba_land", first_cam=int(cams[0]), aborted=self.ba_aborts > aborts,
                    outliers=int(self.last_ba_stats.get("outliers", 0)),
                    divergent=int(self.last_ba_stats.get("aborted_divergent", 0)),
                    max_cam_move_m=float(moved_c.max()) if len(cams) else 0.0,
                    median_point_move_m=float(np.median(moved_p[live])) if live.any() else 0.0,
                    chi2=float(self.last_ba_stats.get("chi2", float("nan"))))
        return f

    def apply_triangulation(inner):
        def f(self, kf, *a, **k):
            inner(self, kf, *a, **k)
            rec.log(self, ev="triangulated", kf=int(kf), new_points=int(self.last_triangulation.get("new_points", 0)))
        return f

    def apply_fuse(inner):
        def f(self, *a, **k):
            inner(self, *a, **k)
            rec.log(self, ev="fused", added=int(self.last_fuse.get("added_obs", 0)),
                    merged=int(self.last_fuse.get("merged", 0)))
        return f

    def cull_keyframes(inner):
        def f(self, kf):
            before = self.arena.kf_valid.copy()
            inner(self, kf)
            gone = np.nonzero(before & ~self.arena.kf_valid)[0]
            if len(gone):
                rec.log(self, ev="cull_keyframes", kf=int(kf), erased=[int(g) for g in gone])
        return f

    def try_relocalize(inner):
        def f(self, fd_host):
            twin = []
            if rec.comparing():
                def run_twin():
                    reloc = clone_system(rec.systems["card"], "cpu").tracker.relocalizer
                    got = inner(reloc, fd_host)
                    twin.append([None if got is None else [int(got.kf), int(got.n_inliers)], _steps(reloc.last_report)])
                rec.guarded("relocalization", run_twin)
            got = inner(self, fd_host)
            card = [None if got is None else [int(got.kf), int(got.n_inliers)], _steps(self.last_report)]
            rec.log(self, ev="relocalize", result=card[0], steps=card[1])
            if twin:
                rec.add_stage("relocalization", frame=int(rec.systems["card"].tracker.frame_id),
                              card=card, cpu=twin[0], same=card == twin[0])
            return got
        return f

    def optimize(inner):
        def f(prob, K, *a, **k):
            res = inner(prob, K, *a, **k)
            if rec.comparing() and prob.cam_pose.is_cuda:
                def compare():
                    ref = inner(_cpu(prob), K, *a, **k)
                    free = _np(prob.cam_mask) & ~_np(prob.cam_fixed)
                    pts, obs = _np(prob.pt_mask), _np(prob.obs_mask)
                    dc = np.linalg.norm(_centres(_np(res.cam_pose)) - _centres(_np(ref.cam_pose)), axis=1)[free]
                    dp = np.linalg.norm(_np(res.pt_pos).astype(np.float64) - _np(ref.pt_pos), axis=1)[pts]
                    rec.add_stage("local_ba", max_cam_m=float(dc.max()) if len(dc) else 0.0,
                                  max_point_m=float(dp.max()) if len(dp) else 0.0,
                                  median_point_m=float(np.median(dp)) if len(dp) else 0.0,
                                  inlier_flips=int((_np(res.obs_inlier) != _np(ref.obs_inlier))[obs].sum()),
                                  obs=int(obs.sum()),
                                  chi2_rel=abs(float(res.total_chi2) - float(ref.total_chi2))
                                  / max(abs(float(ref.total_chi2)), 1e-12))
                rec.guarded("local_ba", compare)
            return res
        return f

    def _store_twin(mapper):
        store = types.SimpleNamespace(packs=mapper.kf_store.packs.cpu(), descs=mapper.kf_store.descs.cpu())
        return types.SimpleNamespace(kf_store=store, K=mapper.K, cfg=mapper.cfg)

    def triangulate(inner):
        def f(self, idxs, poses, cand, min_baseline):
            res = inner(self, idxs, poses, cand, min_baseline)
            if rec.comparing() and idxs.is_cuda:
                def compare():
                    ref = inner(_store_twin(self), idxs.cpu(), poses.cpu(), cand.cpu(), min_baseline)
                    va, vb = _np(res.valid), _np(ref.valid)
                    both = va & vb
                    dp = np.linalg.norm(_np(res.pts)[both].astype(np.float64) - _np(ref.pts)[both], axis=1)
                    pair = (_np(res.ni) != _np(ref.ni)) | (_np(res.nf) != _np(ref.nf))
                    rec.add_stage("triangulation", valid=int(va.sum()), valid_flips=int((va != vb).sum()),
                                  pair_mismatch=int(pair[both].sum()), max_point_m=float(dp.max()) if len(dp) else 0.0)
                rec.guarded("triangulation", compare)
            return res
        return f

    def fuse(inner):
        def f(self, idxs, poses, cand, *pts):
            res = inner(self, idxs, poses, cand, *pts)
            if rec.comparing() and idxs.is_cuda:
                def compare():
                    ref = inner(_store_twin(self), idxs.cpu(), poses.cpu(), cand.cpu(), *[p.cpu() for p in pts])
                    a, b = _np(res), _np(ref)
                    rec.add_stage("fusion", entries=int((a >= 0).sum()), mismatch=int((a != b).sum()))
                rec.guarded("fusion", compare)
            return res
        return f

    def track_core(inner):
        def f(self, state, fd, block):
            out = inner(self, state, fd, block)
            if rec.comparing() and fd.xy.is_cuda:
                def compare():
                    ref = inner(self, _cpu(state), _cpu(fd), _cpu(block))
                    s, r = _np(out[1]), _np(ref[1])
                    dc = np.linalg.norm(_centres(s[:16].reshape(4, 4)) - _centres(r[:16].reshape(4, 4)))
                    rec.add_stage("track_core", dispatched_at=int(self.frame_id), centre_m=float(dc),
                                  inliers_diff=abs(int(s[17]) - int(r[17])),
                                  motion_inliers_diff=abs(int(s[22]) - int(r[22])),
                                  slot_mismatch=int((_np(out[0].assoc_slot) != _np(ref[0].assoc_slot)).sum()))
                rec.guarded("track_core", compare)
            return out
        return f

    def frontend(inner):
        def f(self, left, right):
            fd = inner(self, left, right)
            if rec.comparing() and left.is_cuda:
                def compare():
                    ref = inner(self, left.cpu(), right.cpu())

                    def keyed(x):
                        v = _np(x.valid)
                        keys = zip(*(_np(x.xy)[v].T.tolist()), _np(x.octave)[v].tolist())
                        return dict(zip(keys, zip(map(bytes, _np(x.desc)[v]), _np(x.u_right)[v].tolist())))

                    a, b = keyed(fd), keyed(ref)
                    common = a.keys() & b.keys()
                    rec.add_stage("frontend", valid=len(a), valid_diff=abs(len(a) - len(b)),
                                  keypoints_not_shared=len(a.keys() ^ b.keys()),
                                  descriptor_mismatch=sum(a[k][0] != b[k][0] for k in common),
                                  stereo_mismatch=sum(a[k][1] != b[k][1] for k in common))
                rec.guarded("frontend", compare)
            return fd
        return f

    wrap(M, "process_keyframe", process_keyframe)
    wrap(M, "_cull_points", cull_points)
    wrap(M, "_local_ba", local_ba_launch)
    wrap(M, "_apply_ba", apply_ba)
    wrap(M, "_apply_triangulation", apply_triangulation)
    wrap(M, "_apply_fuse", apply_fuse)
    wrap(M, "_cull_keyframes", cull_keyframes)
    wrap(M, "_triangulate", triangulate)
    wrap(M, "_fuse", fuse)
    wrap(R, "try_relocalize", try_relocalize)
    wrap(T, "_track_core", track_core)
    wrap(F, "__call__", frontend)
    local_ba.optimize = optimize(local_ba.optimize)


def _steps(report) -> list:
    return [{k: (len(v) if k == "rows" else v) for k, v in step.items()} for step in report]


# ---------------------------------------------------------------- the comparison

def first_parting(a: list, b: list, exact_only: bool = False):
    """The first event at which two logs differ: exactly, or (exact_only) in an
    integer field, a list or the event kind. Returns (index, event a, event b) or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if exact_only:
            kx = {k: v for k, v in x.items() if not isinstance(v, float)}
            ky = {k: v for k, v in y.items() if not isinstance(v, float)}
            if kx != ky:
                return i, x, y
        elif x != y:
            return i, x, y
    if len(a) != len(b):
        return min(len(a), len(b)), (a[len(b)] if len(a) > len(b) else None), (b[len(a)] if len(b) > len(a) else None)
    return None


def frame_differences(a: SlamSystem, b: SlamSystem, start: int) -> dict:
    """Per frame from `start`: the frames lost in one run only, and the camera
    centres of the frames both tracked, as each tracker recorded them."""
    ra, rb = a.tracker.records, b.tracker.records
    n = min(len(ra), len(rb))
    only = [[r.frame_id, r.lost] for r, q in zip(ra[start:n], rb[start:n]) if r.lost != q.lost]
    d = [[r.frame_id, round(float(np.linalg.norm(_centres(r.pose) - _centres(q.pose))), 6)]
         for r, q in zip(ra[start:n], rb[start:n]) if r.pose is not None and q.pose is not None]
    first = next((fd for fd in d if fd[1] > 0), None)
    return {"lost_in_first_only": only, "first_pose_difference": first,
            "max_centre_m": max((x[1] for x in d), default=0.0), "centre_m": d}


def outcome(system: SlamSystem, start: int) -> dict:
    recs = system.tracker.records[start:]
    events = [e for e in system.tracker.metrics.records if e.get("relocalized") and e["frame_id"] >= start]
    return {"lost": [r.frame_id for r in recs if r.lost],
            "relocalized": [[e["frame_id"], e["reloc_kf"], e["inliers"]] for e in events],
            "keyframes": int(system.arena.n_valid_kfs), "map_points": int(system.arena.n_valid_pts)}


def _config(geometry: str) -> SlamConfig:
    return multi_loop_config() if geometry == "multi-loop" else SlamConfig()


def _render_init(geometry: str, blackout: range):
    global _WORLD, _BLACKOUT
    _WORLD, _BLACKOUT = bench_world(_config(geometry)), blackout


def _render(f: int):
    return frame_pair(_WORLD, f, _BLACKOUT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snapshot", type=int, default=100, help="frames tracked on the card before the copies")
    ap.add_argument("--end", type=int, default=150, help="frames tracked in all")
    ap.add_argument("--blackout", default=f"{BLACKOUT[0]}-{BLACKOUT[-1]}", help="gray frames A-B (inclusive)")
    ap.add_argument("--geometry", choices=("default", "multi-loop"), default="default",
                    help="multi-loop: 640x240, 800 features (a small run on the CPU)")
    ap.add_argument("--device", default="cuda", help="where the original and its control run")
    ap.add_argument("--procs", type=int, default=8, help="render processes")
    ap.add_argument("--no-landing", action="store_true", help="the heavy stage without the landing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from slam_framework_torch.utils import cuda_timing

    if args.no_landing:
        drop_the_landing()
    t_start = time.perf_counter()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(cuda_timing.card_line(), flush=True)
    cfg = _config(args.geometry)
    world = bench_world(cfg)
    blackout = parse_blackout(args.blackout)
    with multiprocessing.get_context("spawn").Pool(args.procs, initializer=_render_init,
                                                   initargs=(args.geometry, blackout)) as pool:
        pairs = pool.map(_render, range(args.end))
    staged = {"card": [torch.from_numpy(np.stack(p)).to(dev) for p in pairs],
              "cpu": [torch.from_numpy(np.stack(p)) for p in pairs]}

    rec = Recorder()
    install(rec)
    card = SlamSystem(cfg, sensor="stereo", sync_every=SYNC, device=dev)
    rec.register("card", card)
    rec.current = "card"
    rec.compare = False
    t0 = time.perf_counter()
    for f in range(args.snapshot):
        card.track_stereo_device(staged["card"][f], world.timestamps[f])
    warm_s = time.perf_counter() - t0
    print(json.dumps({"snapshot": args.snapshot, "warm_s": round(warm_s, 1), "outcome": outcome(card, 0)}), flush=True)
    systems = {"card": card, "card_copy": clone_system(card, dev), "cpu": clone_system(card, "cpu"),
               "cpu_copying": clone_system(card, "cpu")}
    for name in SYSTEMS[1:]:
        rec.register(name, systems[name])
    rec.logs["card"] = []  # the stretch only
    rec.compare = True
    secs = dict.fromkeys(SYSTEMS, 0.0)
    for f in range(args.snapshot, args.end):
        for name in SYSTEMS:
            rec.current = name
            frame = staged["card" if name.startswith("card") else "cpu"][f]
            t0 = time.perf_counter()
            if name == "cpu_copying":
                with _CopyingConversions():
                    systems[name].track_stereo_device(frame, world.timestamps[f])
            else:
                systems[name].track_stereo_device(frame, world.timestamps[f])
            secs[name] += time.perf_counter() - t0
        print(json.dumps({"frame": f, "state": {n: systems[n].tracker.state.name for n in SYSTEMS},
                          "seconds": {n: round(v, 1) for n, v in secs.items()}}), flush=True)

    result = {"snapshot": args.snapshot, "end": args.end, "landing": not args.no_landing, "warm_s": warm_s,
              "seconds": secs, "outcome": {n: outcome(systems[n], args.snapshot) for n in SYSTEMS}}
    for a, b in (("card", "card_copy"), ("cpu", "cpu_copying"), ("card", "cpu")):
        result[f"{a}_vs_{b}"] = {"first_event": first_parting(rec.logs[a], rec.logs[b]),
                                 "first_discrete_event": first_parting(rec.logs[a], rec.logs[b], exact_only=True),
                                 "frames": frame_differences(systems[a], systems[b], args.snapshot)}
    summary = {}
    for prog, rows in rec.stage.items():
        ok = [r for r in rows if "error" not in r]
        keys = [k for k in (ok[0] if ok else {}) if isinstance(ok[0][k], (int, float)) and not isinstance(ok[0][k], bool)]
        summary[prog] = {"calls": len(ok), "errors": [r["error"] for r in rows if "error" in r][:3],
                         **{f"max_{k}": max(r[k] for r in ok) for k in keys}}
        if prog == "relocalization":
            summary[prog]["all_same"] = all(r["same"] for r in ok)
    result["same_inputs"] = summary
    for key in ("outcome", "card_vs_card_copy", "cpu_vs_cpu_copying", "card_vs_cpu", "same_inputs"):
        print(json.dumps({key: result[key]}, default=str), flush=True)
    for row in rec.stage.get("relocalization", []):
        print(json.dumps({"relocalization_same_inputs": row}, default=str), flush=True)
    result["logs"] = rec.logs
    result["stage"] = rec.stage
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, default=str)
    print(json.dumps({"total_s": time.perf_counter() - t_start}), flush=True)


if __name__ == "__main__":
    main()

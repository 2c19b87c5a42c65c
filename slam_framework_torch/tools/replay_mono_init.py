"""Replay the monocular initialization of the bench world on the card and on
the CPU: which stage decides the frame it starts at.

    python -m slam_framework_torch.tools.replay_mono_init [--frames 4] [--out FILE]

The pixels are those of `chip_smoke.py`'s phase 10: the left image of each
bench frame (`rgbd_pair`), `SlamConfig()` defaults with `sensor="monocular"`.
1. Live: a MonoTracker on each device takes frames 0 .. frames-1 through
   `track_image` until it initializes.
2. Front-ends: the initializer's front-end (2x features) of every frame on
   both devices, compared (valid features, keypoints not shared, descriptors
   that differ on a shared keypoint and by how many bits), and the level
   images of the pyramid (largest difference). Beside it, on the CPU alone,
   the descriptors with the blurred levels computed in float64 and rounded to
   float32: a BRIEF bit compares two blurred pixels, which the synthetic
   world's flat regions make equal in exact arithmetic, so one rounding
   changes it.
3. Crossed: for each source of features (card, CPU) and each device that
   matches and solves (card, CPU), a MonoTracker is fed those features in
   place of its own front-end's, so the attempts see the same features and,
   where their matches agree, the same `sample_hypotheses` index sets (the
   tracker's generator, seeded 3, one draw per attempt). Printed per attempt:
   the matches, the E and H scores (best of the 200 sets) and RH, per motion
   (4 of E, 8 of H) `ngood` and the parallax of its 50th pair, and each
   acceptance test's margin (positive passes): RH against 0.40 picks the
   model; `ngood` against 50 and against 0.9 x the model's inliers; the clear
   winner (E: the second motion against 0.7 x the best; H: against 0.75 x the
   best); the parallax against 1 degree.
With the same features the two solving devices differing only by rounding,
and the two feature sources giving different attempts, the front-end decides.

Prints the card's name and power limit and one JSON line per part; `--out`
takes them all as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from slam_framework_torch.config import SlamConfig
from slam_framework_torch.ops import pyramid
from slam_framework_torch.pipeline.frame import FrameData
from slam_framework_torch.pipeline.mono_tracker import MonoTracker
from slam_framework_torch.solvers import initializer as ini
from slam_framework_torch.tools.track_bench_world import bench_world


def _np(t):
    return t.detach().cpu().numpy()


class Capture:
    """The initializer's intermediate values of each `initialize_two_view` call."""

    def __init__(self):
        self.calls = []
        self._cur = None
        for name in ("_sampson_chi2", "_transfer_chi2_H", "_decompose_H", "_check_motions", "initialize_two_view"):
            setattr(ini, name, self._wrap(name, getattr(ini, name)))

    def _wrap(self, name, inner):
        def f(*a, **k):
            if name == "initialize_two_view":
                self._cur = {"mask": _np(a[2]).astype(bool), "args": [_np(x) for x in (a[0], a[1], a[2], a[4])],
                             "K": a[3]}
                out = inner(*a, **k)
                self._cur["ok"] = bool(out.ok)
                self.calls.append(self._cur)
                self._cur = None
                return out
            out = inner(*a, **k)
            if self._cur is not None:
                if name == "_sampson_chi2":
                    self._cur["chi2_e"] = _np(out)
                elif name == "_transfer_chi2_H":
                    self._cur["chi2_h"] = _np(out)
                elif name == "_decompose_H":
                    self._cur["h_degenerate"] = bool(out[2])
                else:
                    self._cur["ngood"], self._cur["parallax"] = _np(out[2]), _np(out[3])
            return out
        return f


def margins(c: dict) -> dict:
    """The acceptance of initialize_two_view (solvers/initializer.py) as margins."""
    mask = c["mask"]
    inl_e = (c["chi2_e"] < ini.CHI2_F) & mask[None]
    score_e = np.where(inl_e, ini.SCORE_OFFSET - c["chi2_e"], 0.0).sum(axis=1)
    inl_h = (c["chi2_h"] < ini.CHI2_H) & mask[None]
    score_h = np.where(inl_h, ini.CHI2_H - c["chi2_h"], 0.0).sum(axis=1)
    SF, SH = float(score_e.max()), float(score_h.max())
    RH = SH / max(SH + SF, 1e-9)
    planar = RH > 0.40
    ngood = c["ngood"].astype(np.int64).copy()
    if c["h_degenerate"]:
        ngood[4:] = -1
    model = ngood[4:] if planar else ngood[:4]
    par = c["parallax"][4:] if planar else c["parallax"][:4]
    b = int(np.argmax(model))
    n_best = int(model[b])
    n_inl = int((inl_h[int(np.argmax(score_h))] if planar else inl_e[int(np.argmax(score_e))]).sum())
    second = int(np.sort(model)[-2])
    clear = (0.75 * n_best - second) if planar else (0.7 * n_best - second)
    m = {"matches": int(mask.sum()), "score_E": SF, "score_H": SH, "RH": RH, "model": "H" if planar else "E",
         "RH_margin_to_0.40": RH - 0.40, "ngood_E": ngood[:4].tolist(), "ngood_H": ngood[4:].tolist(),
         "parallax_deg_E": [round(float(x), 4) for x in c["parallax"][:4]],
         "parallax_deg_H": [round(float(x), 4) for x in c["parallax"][4:]],
         "best_motion": b, "ngood_best": n_best, "model_inliers": n_inl,
         "margin_ngood_vs_50": n_best - 50, "margin_ngood_vs_0.9_inliers": n_best - 0.9 * n_inl,
         "margin_clear_winner": clear, "margin_parallax_deg": float(par[b]) - 1.0}
    m["accepted"] = c["ok"]
    clear_ok = clear > 0 if planar else clear >= 0
    replicated = (n_best >= 50) and (n_best > 0.9 * n_inl) and clear_ok and float(par[b]) > 1.0
    m["margins_agree_with_the_solver"] = replicated == c["ok"]
    return m


def _fd_to(fd: FrameData, dev) -> FrameData:
    return FrameData(*[t.to(dev) for t in fd])


def run_tracker(cfg, dev, images, cap: Capture, features=None) -> dict:
    """Feed images until the tracker initializes; `features` (per frame, a
    FrameData) replaces its init front-end's output."""
    tracker = MonoTracker(cfg, device=dev)
    if features is not None:
        tracker._init_frontend = lambda img: _fd_to(features[tracker.frame_id], dev)
    n0 = len(cap.calls)
    for f, img in enumerate(images):
        tracker.track_image(img, float(f) * 0.1)
        if tracker.last_init is not None:
            break
    calls = cap.calls[n0:]
    return {"init": tracker.last_init, "attempts": [margins(c) for c in calls], "calls": calls}


def _sign_free(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return float(min(np.abs(a - b).max(), np.abs(a + b).max()))


def stage_probe(call: dict, devices: dict) -> dict:
    """The E path of one initialize_two_view call, stage by stage, on each device
    from the same inputs, and in float64 on the CPU: the best hypothesis's
    inliers, the refit E on them (sign-free difference), its 4 motions from one
    E, and `ngood` / parallax of CheckRT from one set of motions."""
    uv1, uv2, mask, sets = call["args"]
    K = call["K"]
    runs = dict(devices, cpu64=torch.device("cpu"))

    def inputs(name):
        dt = torch.float64 if name == "cpu64" else torch.float32
        d = runs[name]
        x1 = ini._normalize(torch.from_numpy(uv1).to(d, dt), K)
        x2 = ini._normalize(torch.from_numpy(uv2).to(d, dt), K)
        return x1, x2, torch.from_numpy(mask).to(d), torch.from_numpy(sets).to(d)

    out, inl, E, mot = {}, {}, {}, {}
    for name in runs:
        x1, x2, m, st = inputs(name)
        Eh = ini._eight_point_E(x1[st], x2[st])
        chi2 = ini._sampson_chi2(Eh, x1, x2, K)
        inl_e = (chi2 < ini.CHI2_F) & m[None]
        score = torch.where(inl_e, ini.SCORE_OFFSET - chi2, torch.zeros_like(chi2)).sum(dim=1)
        inl[name] = _np(inl_e[torch.argmax(score)])
        out[f"best_hypothesis_{name}"] = int(torch.argmax(score))
    ref_inl = inl["card"]
    out["inliers_differ_from_the_card"] = {n: int((v != ref_inl).sum()) for n, v in inl.items()}
    for name in runs:  # the refit from the card's inlier set
        x1, x2, m, _ = inputs(name)
        w = torch.from_numpy(ref_inl).to(x1.device, x1.dtype)
        E[name] = _np(ini._eight_point_E_weighted(x1, x2, w)).astype(np.float64)
    out["E_refit_vs_cpu64"] = {n: _sign_free(E[n], E["cpu64"]) for n in runs}
    for name in runs:  # the motions from the float64 E
        dt = torch.float64 if name == "cpu64" else torch.float32
        Rs, ts = ini._decompose_E(torch.from_numpy(E["cpu64"]).to(runs[name], dt))
        mot[name] = (_np(Rs).astype(np.float64), _np(ts).astype(np.float64))
    out["motions_vs_cpu64"] = {n: float(max(np.abs(mot[n][0] - mot["cpu64"][0]).max(),
                                            np.abs(mot[n][1] - mot["cpu64"][1]).max())) for n in runs}
    for src in runs:  # CheckRT of each device's own refit, and of the float64 motions
        for motions in ("own", "cpu64"):
            x1, x2, m, _ = inputs(src)
            dt, d = x1.dtype, x1.device
            if motions == "own":
                Rs, ts = ini._decompose_E(torch.from_numpy(E[src]).to(d, dt))
            else:
                Rs, ts = (torch.from_numpy(v).to(d, dt) for v in mot["cpu64"])
            mk = (torch.from_numpy(ref_inl).to(d) & m)[None].expand(4, -1)
            _, _, ngood, par = ini._check_motions(Rs, ts, x1, x2, mk, K, 1.0)
            out[f"checkrt_{src}_motions_{motions}"] = {"ngood": _np(ngood).tolist(),
                                                       "parallax_deg": [round(float(x), 4) for x in _np(par)]}
    return out


def compare_features(a, b) -> dict:
    """Two feature sets (FrameData or Features) of one image, keypoint by keypoint."""
    def keyed(x):
        v = _np(x.valid)
        keys = zip(*(_np(x.xy)[v].T.tolist()), _np(x.octave)[v].tolist())
        return dict(zip(keys, _np(x.desc)[v].view(np.uint32)))

    ka, kb = keyed(a), keyed(b)
    common = sorted(ka.keys() & kb.keys())
    bits = np.array([int(np.bitwise_count(ka[k] ^ kb[k]).sum()) for k in common])
    differ = bits[bits > 0]
    return {"valid": [len(ka), len(kb)], "keypoints_not_shared": len(ka.keys() ^ kb.keys()),
            "descriptor_mismatch": len(differ), "bits_differing_mean": float(differ.mean()) if len(differ) else 0.0,
            "bits_differing_max": int(differ.max()) if len(differ) else 0}


def blur_rounding_probe(extractor, cfg, image: np.ndarray) -> dict:
    """On the CPU alone: the descriptors of one image with its blurred levels
    computed as the front-end does, and computed in float64 and rounded to
    float32 (a change of one rounding): how many differ, by how many bits."""
    img = torch.from_numpy(image).to(torch.float32)
    nl, sf = cfg.orb.num_levels, cfg.orb.scale_factor
    levels = pyramid.build_pyramid(img, nl, sf)
    blurred = pyramid.build_blurred_pyramid(img, nl, sf)
    mats = pyramid._composed_blur_matrices(img.shape[0], img.shape[1], nl, sf)
    img64 = img.to(torch.float64)
    rounded = [(torch.from_numpy(M).double() @ img64 @ torch.from_numpy(N.T.copy()).double()).float() for M, N in mats]
    return {"blur_max_abs_diff": max(float((x - y).abs().max()) for x, y in zip(blurred, rounded)),
            **compare_features(extractor.extract_from_pyramid(levels, blurred),
                               extractor.extract_from_pyramid(levels, rounded))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="the card (the other device is the CPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from slam_framework_torch.utils import cuda_timing

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(cuda_timing.card_line(), flush=True)
    cfg = dataclasses.replace(SlamConfig(), sensor="monocular")
    world = bench_world(cfg)
    images = [world.rgbd_pair(f)[0] for f in range(args.frames)]
    devices = {"card": dev, "cpu": torch.device("cpu")}
    cap = Capture()
    out = {"same_as_render": all(np.array_equal(im, world.render(f)) for f, im in enumerate(images))}

    out["live"] = {name: run_tracker(cfg, d, images, cap) for name, d in devices.items()}
    print(json.dumps({"same_as_render": out["same_as_render"],
                      "live": {n: {k: v[k] for k in ("init", "attempts")} for n, v in out["live"].items()}}),
          flush=True)

    fronts = {name: MonoTracker(cfg, device=d)._init_frontend for name, d in devices.items()}
    feats = {name: [fronts[name](torch.from_numpy(im).to(d)) for im in images] for name, d in devices.items()}
    out["frontend"] = [compare_features(feats["card"][f], feats["cpu"][f]) for f in range(args.frames)]
    levels = []
    for im in images:
        img = torch.from_numpy(im).to(torch.float32)
        pc = pyramid.build_pyramid(img.to(dev), cfg.orb.num_levels, cfg.orb.scale_factor)
        pp = pyramid.build_pyramid(img, cfg.orb.num_levels, cfg.orb.scale_factor)
        levels.append([float((_np(a) - _np(b)).__abs__().max()) for a, b in zip(pc, pp)])
    out["pyramid_max_abs_diff_per_level"] = levels
    out["blur_rounding_on_the_cpu"] = [blur_rounding_probe(fronts["cpu"].extractor, cfg, im) for im in images]
    print(json.dumps({k: out[k] for k in ("frontend", "pyramid_max_abs_diff_per_level", "blur_rounding_on_the_cpu")}),
          flush=True)

    out["crossed"] = {}
    for src in devices:
        for solver, d in devices.items():
            key = f"features_{src}_solved_{solver}"
            out["crossed"][key] = run_tracker(cfg, d, images, cap, features=feats[src])
            print(json.dumps({key: {k: out["crossed"][key][k] for k in ("init", "attempts")}}), flush=True)
    first = out["crossed"]["features_card_solved_card"]["calls"][0]
    out["stages_first_attempt"] = stage_probe(first, devices)
    print(json.dumps({"stages_first_attempt": out["stages_first_attempt"]}), flush=True)
    for part in [out["live"].values(), out["crossed"].values()]:
        for v in part:
            v.pop("calls")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh)


if __name__ == "__main__":
    main()

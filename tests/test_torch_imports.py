"""The port stands alone: no jax, cv2 or reference-package import; copied host
modules (config, arena, trajectory) equal the reference's; numerics pinned."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import slam_framework_tpu.config as jconfig
from slam_framework_tpu.io import trajectory as jtraj
from slam_framework_tpu.map.arena import MapArena as JArena
import slam_framework_torch
from slam_framework_torch import config as tconfig, interop, native
from slam_framework_torch.io import trajectory as ttraj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import numpy as np
import torch
import slam_framework_torch
mods = [m.name for m in pkgutil.walk_packages(slam_framework_torch.__path__, "slam_framework_torch.")]
for m in mods:
    importlib.import_module(m)
from slam_framework_torch import config
from slam_framework_torch.io import synthetic
from slam_framework_torch.system import SlamSystem
cam = config.CameraConfig(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, bf=216.0)
cfg = config.SlamConfig(camera=cam, orb=config.OrbConfig(num_features=800, num_levels=4),
                        capacity=config.CapacityConfig(max_keyframes=8, max_map_points=8192,
                                                       max_features=1024, local_window_points=2048))
world = synthetic.make_world(num_frames=3, cam=cam, seed=1, speed=0.8, yaw_rate=0.004)
s = SlamSystem(cfg, sync_every=1, device=torch.device("cpu"))
for f in range(3):
    s.track_stereo(*world.stereo_pair(f), world.timestamps[f])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cv2", "slam_framework_tpu"))
want = ["geometry.triangulation", "optim.local_ba", "pipeline.kf_store", "pipeline.mapping_ops",
        "pipeline.local_mapper", "tools.ba_synthetic", "tools.track_bench_world",
        "geometry.sim3", "bow.vocabulary", "bow.database", "solvers.sim3solver", "optim.pose_graph",
        "optim.global_ba", "pipeline.loop_closer", "tools.bench_torch",
        "solvers.pnp", "pipeline.relocalization", "io.checkpoint",
        "io.png", "io.kitti", "viz.publisher", "examples.main_stereo", "examples.main_mono",
        "examples.main_rgbd", "parallel.mesh", "parallel.dist_ba", "parallel.dist_pose_graph",
        "parallel.map_shard", "parallel.multihost", "tools.multihost_demo"]
missing = [w for w in want if "slam_framework_torch." + w not in sys.modules]
print(json.dumps({"modules": len(mods), "missing": missing, "frames": len(s.tracker.records),
                  "lost": sum(r.lost for r in s.tracker.records), "bad": bad,
                  "vocab_nodes": s.vocab.num_nodes, "db": len(s.loop_closer.db.frames) + (s.loop_closer._bow_pending is not None),
                  "relocalizer": type(s.tracker.relocalizer).__name__}))
"""


def test_port_imports_and_tracks_without_jax_cv2_or_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["modules"] >= 40 and res["frames"] == 3 and res["lost"] == 0
    assert res["missing"] == []
    # the shipped vocabulary loaded and the first keyframe reached place recognition
    assert res["vocab_nodes"] == 110343 and res["db"] >= 1
    # and the relocalizer was built from the loop closer
    assert res["relocalizer"] == "Relocalizer"


def test_tf32_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


_CONFIG_CLASSES = ["CameraConfig", "OrbConfig", "MatcherConfig", "TrackerConfig", "MappingConfig",
                   "LoopConfig", "CapacityConfig", "SlamConfig"]


@pytest.mark.parametrize("name", _CONFIG_CLASSES)
def test_config_defaults_equal_reference(name):
    j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
    jf = [f.name for f in dataclasses.fields(j)]
    assert [f.name for f in dataclasses.fields(t)] == jf
    for field in jf:
        a, b = getattr(j, field), getattr(t, field)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), field
        else:
            assert a == b, field
    if name == "SlamConfig":
        assert (t.depth_threshold, t.min_frames_between_kfs, t.max_frames_between_kfs) == (
            j.depth_threshold, j.min_frames_between_kfs, j.max_frames_between_kfs)


def _small_cap(mod):
    return mod.CapacityConfig(max_keyframes=8, max_map_points=512, max_features=64, max_obs_per_point=6)


def test_arena_copy_and_operations_match_reference():
    rng = np.random.default_rng(0)
    ja = JArena.create(_small_cap(jconfig))
    n = 64
    for k in range(3):
        pids = ja.add_points(rng.standard_normal((20, 3)).astype(np.float32),
                             rng.integers(0, 2**32, (20, 8), dtype=np.uint64).astype(np.uint32), k,
                             np.ones((20, 3), np.float32), np.ones(20, np.float32), np.ones(20, np.float32))
        idx = np.full(n, -1, np.int32)
        idx[rng.choice(n, 20, replace=False)] = pids
        if k:
            idx[rng.choice(n, 10, replace=False)] = rng.integers(0, pids[0], 10)  # re-observations
        ja.add_keyframe(np.eye(4, dtype=np.float32), k, 0.1 * k, rng.random((n, 2)).astype(np.float32),
                        np.full(n, -1.0, np.float32), np.full(n, -1.0, np.float32), np.zeros(n, np.int16),
                        np.zeros(n, np.float32), np.zeros((n, 8), np.uint32), np.ones(n, bool), idx)
    ta = interop.arena(ja)
    assert isinstance(ta.cap, tconfig.CapacityConfig)
    for f in dataclasses.fields(JArena):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
    for k in range(3):
        np.testing.assert_array_equal(ta.covisibility_counts(k), ja.covisibility_counts(k))
        np.testing.assert_array_equal(ta.covisible_keyframes(k, min_shared=1), ja.covisible_keyframes(k, min_shared=1))
    ja.erase_keyframe(1)
    ta.erase_keyframe(1)
    np.testing.assert_array_equal(ta.pt_obs_kf, ja.pt_obs_kf)
    np.testing.assert_array_equal(ta.effective_kf_pose(1), ja.effective_kf_pose(1))


def test_native_arena_ops_build_in_port_build_dir():
    lib = native.load_arena_ops()
    assert lib is not None
    assert native.library_path(native.SOURCE).startswith(slam_framework_torch.BUILD_DIR)
    assert native.SOURCE.startswith(slam_framework_torch.PACKAGE_DIR)


def test_trajectory_export_and_ate_match_reference(tmp_path):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(1)
    T = np.tile(np.eye(4), (10, 1, 1))
    T[:, :3, :3] = Rotation.random(10, random_state=2).as_matrix()
    T[:, :3, 3] = rng.standard_normal((10, 3))
    est = T.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (10, 3))
    for align in ("none", "se3", "sim3"):
        assert ttraj.ate_rmse(est, T, align=align) == jtraj.ate_rmse(est, T, align=align)
    ttraj.save_kitti(str(tmp_path / "a.txt"), T)
    jtraj.save_kitti(str(tmp_path / "b.txt"), T)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def _code_lines(path):
    """(line number, text) of a Python file's tokens that are neither comments
    nor docstrings; other files: every line that is not a // comment."""
    if not path.endswith(".py"):
        with open(path, encoding="utf-8", errors="replace") as f:
            return [(i, l) for i, l in enumerate(f, 1) if not l.lstrip().startswith("//")]
    import ast
    import tokenize

    with open(path, "rb") as f:
        tree = ast.parse(f.read())
    doc_lines = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(getattr(first, "value", None), ast.Constant) \
                    and isinstance(first.value.value, str):
                doc_lines.update(range(first.lineno, first.end_lineno + 1))
    out = []
    with open(path, "rb") as f:
        for tok in tokenize.tokenize(f.readline):
            if tok.type in (tokenize.COMMENT, tokenize.ENCODING) or tok.start[0] in doc_lines:
                continue
            out.append((tok.start[0], tok.string))
    return out


def test_port_names_no_path_into_the_reference_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "slam_framework_torch")):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    assert len(files) > 30
    # a "file.py:LINE" citation (the smoke's `replaces` label) is no path to open
    cited = re.compile(r"slam_framework_tpu/[\w/]+\.py:\d+")
    hits = [(os.path.relpath(f, REPO), no) for f in files for no, text in _code_lines(f)
            if "slam_framework_tpu" in cited.sub("", text) or "REFERENCE_DIR" in text]
    assert hits == []
    assert not hasattr(slam_framework_torch, "REFERENCE_DIR")


@pytest.mark.parametrize("ours,theirs", [
    ("slam_framework_torch/ops/orb_pattern.npy", "slam_framework_tpu/ops/orb_pattern.npy"),
    ("slam_framework_torch/csrc/arena_ops.cpp", "slam_framework_tpu/native/arena_ops.cpp"),
    ("slam_framework_torch/assets/orbvoc_synth.npz", "slam_framework_tpu/assets/orbvoc_synth.npz"),
])
def test_port_keeps_its_own_copy_of_reference_data(ours, theirs):
    with open(os.path.join(REPO, ours), "rb") as a, open(os.path.join(REPO, theirs), "rb") as b:
        assert a.read() == b.read()
    from slam_framework_torch.bow import vocabulary
    from slam_framework_torch.ops import brief
    assert os.path.dirname(brief.PATTERN_PATH) == os.path.join(slam_framework_torch.PACKAGE_DIR, "ops")
    assert vocabulary.SHIPPED_VOCABULARY == os.path.join(slam_framework_torch.PACKAGE_DIR, "assets", "orbvoc_synth.npz")


@pytest.mark.parametrize("module,functions", [
    ("optim.pose_graph", None),
    ("optim.global_ba", ["optimize_global", "_pcg_cam"]),
    ("geometry.sim3", None),
])
def test_loop_programs_have_no_host_read_and_no_scatter_reduction(module, functions):
    """The pose graph and the global BA are fixed sequences of launches: nothing in them
    reads a value back to the host, checks a solver's status there or reduces with atomics.
    (`optim/global_ba.py` also holds the host glue that builds a problem from the arena;
    its device program is `optimize_global`.)"""
    import importlib
    import inspect
    import io
    import tokenize

    mod = importlib.import_module("slam_framework_torch." + module)
    src = inspect.getsource(mod) if functions is None else "\n".join(inspect.getsource(getattr(mod, f)) for f in functions)
    toks = tokenize.generate_tokens(io.StringIO(src).readline)
    code = "".join(t.string for t in toks if t.type in (tokenize.NAME, tokenize.OP, tokenize.NUMBER))
    assert "torch.where" in code
    for banned in (".item(", ".cpu(", ".numpy(", ".tolist(", "index_add", "scatter_add", "scatter_reduce", "scatter_(",
                   "bincount", "linalg.solve(", "linalg.inv(", "cholesky", "psum", "axis_name"):
        assert banned not in code, banned
    # a Python scalar made of a tensor is a read-back too (names like `per_point(` are none)
    assert re.findall(r"(?<![A-Za-z0-9_.])(?:float|bool|int)\(", code) == []


def test_entry_points_raise_without_a_card_unless_given_the_cpu(monkeypatch):
    from slam_framework_torch.map.arena import MapArena
    from slam_framework_torch.pipeline.loop_closer import LoopCloser
    from slam_framework_torch.pipeline.tracker import StereoTracker
    from slam_framework_torch.system import SlamSystem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.SlamConfig(capacity=_small_cap(tconfig))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlamSystem(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoopCloser(cfg, MapArena.create(cfg.capacity, 64), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StereoTracker(cfg)
    assert slam_framework_torch.resolve_device("cpu") == torch.device("cpu")
    assert StereoTracker(cfg, device="cpu").device.type == "cpu"

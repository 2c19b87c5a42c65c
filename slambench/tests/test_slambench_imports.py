"""The import guard: no run may hold JAX or the JAX package, and the
reference holds nothing of the program."""

import os
import subprocess
import sys
import types

from slambench import check, manifest


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(' '.join(sorted(sys.modules)))"],
                         cwd=manifest.ROOT, capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": manifest.ROOT})
    return {m.split(".")[0] for m in out.stdout.split()}


def test_harness_imports_neither_jax_nor_the_jax_package():
    tops = _modules_after("import slambench.run, slambench.harness, slambench.calibrate, slambench.faults\n"
                          "from slambench import manifest\n"
                          "c = manifest.Cell(manifest.benchmark(), 'kitti-stereo.drive'); c.readers()\n"
                          "import slam_framework_torch.system")
    assert not tops & set(check.FORBIDDEN)
    assert "slam_framework_torch" in tops


def test_reference_imports_nothing_of_the_program():
    tops = _modules_after("import slambench.reference")
    assert "slam_framework_torch" not in tops and not tops & set(check.FORBIDDEN)
    assert check.reference_imports_program() is None


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert check.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax_free_lookalike", types.ModuleType("jax_free_lookalike"))
    monkeypatch.setitem(sys.modules, "slam_framework_tpu_copy", types.ModuleType("slam_framework_tpu_copy"))
    assert check.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "slam_framework_tpu.ops", types.ModuleType("slam_framework_tpu.ops"))
    assert check.forbidden_modules() == ["jax", "slam_framework_tpu"]


def test_guard_sees_a_reference_that_holds_the_program(monkeypatch):
    from slambench import reference
    from slam_framework_torch.ops import fast

    monkeypatch.setattr(reference, "borrowed", fast.fast_strength_map, raising=False)
    assert "slam_framework_torch" in check.reference_imports_program()


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "slambench.run", "--workload", "kitti-stereo.drive", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT,
                         capture_output=True, text=True, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""

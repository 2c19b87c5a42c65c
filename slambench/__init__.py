"""The benchmark of slam_framework_torch on one NVIDIA H100.

    python -m slambench.run --workload kitti-stereo.drive --seed 12345 --seconds 51 --trace 0

`BENCHMARK.json` at the repository's root names the cells; `slambench/run.py`
runs one. Everything a cell needs is found by name: its configuration in
`configs/`, its traffic mix in `mixes/` and the generator the mix names in
`generators/`, its limits for `correct` in `limits/`, and a reader per
per-layer metric in `metrics/`. The harness
imports neither JAX nor the JAX package, and the reference that decides
`correct` (`reference.py`) imports nothing of the program.
"""

"""Finds every piece of a cell by the names in `BENCHMARK.json`.

A configuration is `slambench/configs/<config>.json`, a traffic mix
`slambench/mixes/<traffic>.json`, which names the generator that reads it
(`slambench/generators/<generator>.py`, a module with `make(mix, spec, seed,
seconds, tail_frames, device)`), a per-layer metric the reader
`slambench/metrics/<metric>.py` (a module with `read(ctx) -> float | None`),
and a cell's limits for `correct` `slambench/limits/<workload>.json`. A later
cell, mix, generator or metric is new files and a new entry; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

PACKAGE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE)
HOST_THREADS = 1  # OpenMP / BLAS threads of a run: one process drives the card from one core's work


def pin_host_threads() -> None:
    """Fix the host's math threads before NumPy or PyTorch load, whatever the
    environment says, so that runs on a shared host take the same cores."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config_path(name: str) -> str:
    return os.path.join(PACKAGE, "configs", f"{name}.json")


def mix_path(name: str) -> str:
    return os.path.join(PACKAGE, "mixes", f"{name}.json")


def generator_path(name: str) -> str:
    return os.path.join(PACKAGE, "generators", f"{name}.py")


def reader_path(name: str) -> str:
    return os.path.join(PACKAGE, "metrics", f"{name}.py")


def limits_path(workload: str) -> str:
    return os.path.join(PACKAGE, "limits", f"{workload}.json")


def _load(kind: str, name: str, path: str):
    spec = importlib.util.spec_from_file_location(f"slambench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str) -> Callable:
    return _load("metric", name, reader_path(name)).read


def load_generator(name: str) -> Callable:
    return _load("generator", name, generator_path(name)).make


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One workload of the manifest with its configuration, mix, limits and
    the metrics it reports."""

    def __init__(self, bench: dict, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.spec = load_json(os.path.join(ROOT, self.config_entry["file"]))
        self.mix = load_json(mix_path(self.workload["traffic"]))
        self.limits: Dict[str, dict] = load_json(limits_path(workload))
        self.chips = int(self.workload["chips"])
        self.end_to_end: List[dict] = [m for m in bench["end_to_end"] if applies(m, workload)]
        self.per_layer: List[dict] = [m for m in bench["per_layer"] if applies(m, workload)]

    def generator(self) -> Callable:
        return load_generator(self.mix["generator"])

    def readers(self) -> Dict[str, Callable]:
        return {m["name"]: load_reader(m["name"]) for m in self.per_layer}

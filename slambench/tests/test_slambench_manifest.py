"""Every name in BENCHMARK.json resolves to its files, and the manifest keeps
to the benchmark's contract."""

import os
import re

import pytest

from slambench import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "slambench.run"]
    assert BENCH["paths"] == ["slambench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    cell = manifest.Cell(BENCH, workload)
    assert os.path.isfile(os.path.join(manifest.ROOT, cell.config_entry["file"]))
    assert cell.config_entry["file"].startswith("slambench/")
    assert os.path.isfile(manifest.mix_path(cell.workload["traffic"]))
    assert os.path.isfile(manifest.generator_path(cell.mix["generator"])) and callable(cell.generator())
    assert os.path.isfile(manifest.limits_path(workload))
    assert cell.chips == 1
    assert cell.spec["entry"] in ("track_stereo", "track_monocular")
    assert {"fast_mismatch_px", "pyramid_max_err", "lost_share"} <= set(cell.limits)
    readers = cell.readers()
    assert set(readers) == {m["name"] for m in cell.per_layer} and all(callable(r) for r in readers.values())
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "frames_per_s"}


def test_names_units_and_sources():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or m["unit"] == "%":
            assert m["better"] in ("higher", "lower")
    assert len(BENCH["per_layer"]) == 8
    cells = {w["name"] for w in BENCH["workloads"]}
    assert all(set(m.get("workloads", cells)) <= cells for m in BENCH["end_to_end"] + BENCH["per_layer"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_matches_the_calibration(config):
    """The camera and ORB blocks are the upstream KITTI 00-02 file's, which
    the repository keeps as config/kitti_stereo.json."""
    spec = manifest.load_json(manifest.config_path(config))
    upstream = manifest.load_json(os.path.join(manifest.ROOT, "config", "kitti_stereo.json"))
    for key in ("camera", "orb_parameters", "tuning_params"):
        assert spec[key] == upstream[key]
    # every cut is a key of the file, and none is a width
    reduced = [c for c in BENCH["configs"] if c["name"] == config][0]["reduced"]
    assert all(k in spec and k in spec["assumed"] for k in reduced)
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in reduced)


def test_every_metric_reader_mix_and_generator_is_named():
    """Files under metrics/, mixes/ and generators/ are the manifest's, so none is dead."""
    readers = {f[:-3] for f in os.listdir(os.path.join(manifest.PACKAGE, "metrics")) if f.endswith(".py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}
    mixes = {f[:-5] for f in os.listdir(os.path.join(manifest.PACKAGE, "mixes")) if f.endswith(".json")}
    assert mixes == {w["traffic"] for w in BENCH["workloads"]}
    generators = {f[:-3] for f in os.listdir(os.path.join(manifest.PACKAGE, "generators")) if f.endswith(".py")}
    assert generators == {manifest.load_json(manifest.mix_path(m))["generator"] for m in mixes}

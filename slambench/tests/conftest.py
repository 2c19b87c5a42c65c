"""Shared pieces of the benchmark's own tests (run them with
`python -m pytest slambench/tests -q`; the `cuda` cases run on the card)."""

import json

import pytest

from slambench import manifest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips with a reason where there is none)")


def tiny_spec(config: str) -> dict:
    """A cell's configuration at a size a CPU test holds: the 640x240 camera
    and 800 features on 4 levels of the port's multi-loop tests."""
    spec = manifest.load_json(manifest.config_path(config))
    spec["camera"].update(fx=400.0, fy=400.0, cx=320.0, cy=120.0, width=640, height=240, bf=216.0)
    spec["orb_parameters"].update(num_features=800, num_levels=4)
    spec["capacity"].update(max_keyframes=192, max_map_points=131072, max_features=1024, local_window_points=8192)
    return spec


@pytest.fixture
def tiny_config(tmp_path):
    def write(config: str) -> str:
        path = tmp_path / f"{config}.json"
        path.write_text(json.dumps(tiny_spec(config)))
        return str(path)

    return write


@pytest.fixture
def tiny_mix():
    return dict(manifest.load_json(manifest.mix_path("drive")), world_frames=120, preroll_frames=12)

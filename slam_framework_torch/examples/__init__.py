"""The port's runners, one per sensor, mirroring examples/main_*.py argument for
argument (plus `--device`): `python -m slam_framework_torch.examples.main_stereo`."""

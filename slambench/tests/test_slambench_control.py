"""The lower-precision control on the card: the program's float32 matrix
products in TF32 (the configuration states float32 with TF32 off) must come
out not correct at the cell's own size. Run on the card:

    python -m pytest slambench/tests/test_slambench_control.py -q
"""

import os

import pytest

from slambench import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti-stereo.drive"])
def test_tf32_control_is_not_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32, which the CPU does not have")
    from slambench import harness

    cell = manifest.Cell(manifest.benchmark(), workload)
    res = harness.run_cell(os.path.join(manifest.ROOT, cell.config_entry["file"]), cell.mix, cell.limits,
                           2**31 + 77, 20.0, False, 0.0, tf32=True)
    assert not res["correct"]

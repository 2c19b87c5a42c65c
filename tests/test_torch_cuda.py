"""Card-only checks of the port's CUDA kernel. This file imports neither jax nor
the reference package, so it also runs on a machine that has only the port's
dependencies:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: none — the kernel computes the same fp32 min/max/compare chain as
its plain version, on the whole map.
"""

import numpy as np
import pytest
import torch

from slam_framework_torch.ops import fast_cuda

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 376, 1241), (1, 105, 346), (2, 75, 140), (1, 1, 1), (3, 33, 65)])
def test_kernel_matches_plain_on_card(shape):
    dev = _card()
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, shape).astype(np.float32)).to(dev)
    before = fast_cuda.launches
    got = fast_cuda.fast_nms_strength(img)
    torch.cuda.synchronize()
    assert fast_cuda.launches == before + 1
    assert torch.equal(got, fast_cuda.fast_nms_strength_plain(img))


def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    with pytest.raises(TypeError):
        fast_cuda.fast_nms_strength(torch.zeros(1, 8, 8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        fast_cuda.fast_nms_strength(torch.zeros(8, 16, device=dev).T)

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips on a host without a
CUDA card. The file imports neither jax nor vip_tpu, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips the repository's conftest files, which set up
jax for the vip_tpu tests.)
"""

import numpy as np
import pytest
import torch

from vip_tpu_torch.ops import median, shear
from vip_tpu_torch.ops.fft import rotate_fft_exact_pruned
from vip_tpu_torch.ops.median import nanmedian_axis0, nanmedian_plain
from vip_tpu_torch.ops.shear import (fused_shear_supported,
                                     rotate_fft_exact_fused, rotate_exact)
from vip_tpu_torch.preproc.derotation import _fft_rotate_geometry

pytestmark = pytest.mark.cuda

# H2 against its plain version: the bound of tests/test_pallas_shear.py:39
ROT_TOL = 3e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _specials(n, shape, seed):
    """Random f32 cube with ±inf, ±0.0, denormals, half-NaN and all-NaN
    pixels."""
    rng = np.random.default_rng(seed)
    arr = (rng.standard_normal((n,) + shape) * 100).astype(np.float32)
    arr[3, 0, 0] = np.inf
    arr[5, 0, 1] = -np.inf
    arr[:, 0, 2] = -0.0
    arr[: n // 2, 0, 3] = 0.0
    arr[::2, 0, 4] = np.nan
    arr[:, 0, 5] = np.nan
    arr[7, 1, :] = 1e-42
    arr[8, 2, :] = -1e-42
    arr[4, 3, 7] = np.nan
    return arr


@pytest.mark.parametrize("propagate", [False, True])
@pytest.mark.parametrize("n", [16, 17, 301])
def test_median_kernel_bit_equal_to_plain(cuda_device, n, propagate):
    arr = torch.from_numpy(_specials(n, (11, 150), seed=n)).to(cuda_device)
    before = median.launches
    got = nanmedian_axis0(arr, propagate=propagate)
    ref = nanmedian_plain(arr, 0, propagate)
    torch.cuda.synchronize()
    assert median.launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_median_kernel_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError):
        nanmedian_axis0(torch.zeros((4, 3, 3), dtype=torch.float64,
                                    device=cuda_device))
    with pytest.raises(ValueError):
        nanmedian_axis0(torch.zeros((3, 4, 3), device=cuda_device)
                        .transpose(0, 1))


@pytest.mark.parametrize("y", [32, 64, 128, 256])
def test_shear_kernel_matches_plain(cuda_device, y):
    pad_y, _, py0, px0, cy0, cy1, cx0, cx1 = _fft_rotate_geometry(y, y)
    geom = (pad_y, py0, px0, cy0, cy1, cx0, cx1)
    assert fused_shear_supported(y, pad_y, torch.float32, cuda_device)
    rng = np.random.default_rng(y)
    frames = torch.as_tensor(rng.standard_normal((9, y, y)),
                             dtype=torch.float32, device=cuda_device)
    angles = torch.tensor([0.0, 13.7, 45.0, 61.2, 90.0, 158.9, 225.0, 305.4,
                           -37.5], device=cuda_device)
    before = shear.launches
    got = rotate_fft_exact_fused(frames, angles, *geom)
    ref32 = rotate_fft_exact_pruned(frames, angles, *geom)
    ref64 = rotate_fft_exact_pruned(frames.double(), angles.double(), *geom)
    torch.cuda.synchronize()
    assert shear.launches == before + 3
    for ref in (ref32, ref64):
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got.double() - ref.double()).abs().max()) \
            <= ROT_TOL * scale


def test_shear_route_and_gate(cuda_device):
    frames = torch.zeros((2, 33, 33), device=cuda_device)   # odd: plain
    before = shear.launches
    rotate_exact(frames, torch.tensor([10.0, 20.0]))
    assert shear.launches == before
    pad_y = _fft_rotate_geometry(33, 33)[0]
    geom = (pad_y,) + _fft_rotate_geometry(33, 33)[2:]
    with pytest.raises(ValueError):
        rotate_fft_exact_fused(frames, torch.tensor([10.0, 20.0]), *geom)
    even = torch.zeros((2, 64, 64), dtype=torch.float64, device=cuda_device)
    g64 = _fft_rotate_geometry(64, 64)
    with pytest.raises(ValueError):
        rotate_fft_exact_fused(even, torch.tensor([10.0, 20.0]), g64[0],
                               *g64[2:])


def test_median_gate_frame_bound(cuda_device):
    assert median.nanmedian_supported(torch.empty((3600, 1, 2),
                                                  device=cuda_device))
    assert not median.nanmedian_supported(torch.empty((3601, 1, 2),
                                                      device=cuda_device))

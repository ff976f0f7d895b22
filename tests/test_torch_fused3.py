"""The one-launch three-shear rotation (H4's wrappers and route) against
vip_tpu's Pallas K4 on the CPU.

On a CPU tensor ``rotate_fft_exact_fused3`` and ``rotate_fft_small_fused3``
take their plain versions (``ops.fft.rotate_fft_exact_pruned`` and
``rotate_fft_small_plain``), which compute K4's function. They are held
against vip_tpu's ``rotate_fft_exact_fused3`` / ``rotate_fft_small_fused3``
run in Pallas interpret mode at float32, with the bound and the sizes of
tests/test_pallas_shear.py:39,61 (3e-5 of max(|ref|, 1)): K4's bf16
hi/lo matmul DFT against an FFT, both float32. The kernel itself runs only
on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

import jax.numpy as jnp

from vip_tpu.ops.pallas_shear import (rotate_fft_exact_fused3 as j_exact3,
                                      rotate_fft_small_fused3 as j_small3)
from vip_tpu.preproc.derotation import _fft_rotate_geometry as j_geometry
from vip_tpu_torch.ops import fft, pipeline, shear
from vip_tpu_torch.preproc import derotation

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread for vip_tpu's host calls beside other test workers
    (see tests/test_torch_annular.py)."""
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


ROT_TOL = 3e-5     # tests/test_pallas_shear.py:39


def _bound(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max(), ROT_TOL * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("y", [64, 128])
def test_exact_fused3_plain_matches_pallas_k4(y):
    geom = derotation._fft_rotate_geometry(y, y)
    assert geom == j_geometry(y, y)
    args = (geom[0],) + geom[2:]
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((4, y, y)).astype(np.float32)
    angles = np.array([13.7, 61.2, 158.9, 305.4], np.float32)
    ref = j_exact3(jnp.asarray(frames), jnp.asarray(angles), *args,
                   interpret=True)
    before = shear.fused3_launches
    got = shear.rotate_fft_exact_fused3(torch.from_numpy(frames),
                                        torch.from_numpy(angles), *args)
    assert shear.fused3_launches == before       # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, y, y)
    err, bound = _bound(got, ref)
    assert err < bound, (err, bound)
    # float64 plain version against the same Pallas frames
    got64 = shear.rotate_fft_exact_fused3(
        torch.from_numpy(frames).double(), torch.from_numpy(angles).double(),
        *args)
    err, bound = _bound(got64, ref)
    assert err < bound, (err, bound)


def test_small_fused3_plain_matches_pallas_k4():
    N = 256
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((4, N, N)).astype(np.float32)
    angles = np.array([7.3, 44.2, 1.0, 334.6], np.float32)
    ref = j_small3(jnp.asarray(frames), jnp.asarray(angles), interpret=True)
    got = shear.rotate_fft_small_fused3(torch.from_numpy(frames),
                                        torch.from_numpy(angles))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, N, N)
    err, bound = _bound(got, ref)
    assert err < bound, (err, bound)
    assert torch.equal(got, fft.rotate_fft_small_plain(
        torch.from_numpy(frames), torch.from_numpy(angles)))


@pytest.mark.parametrize("mode", ["auto", "fused", "fused3", "pruned"])
def test_exact_shear_route_on_the_cpu(monkeypatch, mode):
    """Every VIP_EXACT_SHEAR value takes the plain version on a CPU
    tensor, so the routes give the same frames and launch nothing."""
    monkeypatch.setenv("VIP_EXACT_SHEAR", mode)
    assert shear._exact_shear_mode() == mode
    rng = np.random.default_rng(3)
    frames = torch.as_tensor(rng.standard_normal((3, 64, 64)))
    angles = torch.tensor([10.0, 100.0, -37.5], dtype=torch.float64)
    counts = (shear.launches, shear.small_launches, shear.fused3_launches)
    got = shear.rotate_exact(frames, angles)
    geom = derotation._fft_rotate_geometry(64, 64)
    ref = fft.rotate_fft_exact_pruned(frames, angles, geom[0], *geom[2:])
    assert torch.equal(got, ref)
    der = pipeline._derotate_frames(frames, angles, rot_mode="fft")
    assert torch.equal(der, shear.rotate_exact(frames, -angles))
    assert (shear.launches, shear.small_launches,
            shear.fused3_launches) == counts


def test_exact_shear_default_is_auto(monkeypatch):
    monkeypatch.delenv("VIP_EXACT_SHEAR", raising=False)
    assert shear._exact_shear_mode() == "auto"


@pytest.mark.parametrize("mode", ["fused", "packed", "fused3"])
def test_small_shear_route_on_the_cpu(monkeypatch, mode):
    """On the CPU fft-small is always the packed path, whatever
    VIP_SMALL_SHEAR says (vip_tpu's CPU behaviour)."""
    monkeypatch.setenv("VIP_SMALL_SHEAR", mode)
    rng = np.random.default_rng(5)
    cube = torch.as_tensor(rng.standard_normal((4, 64, 64)))
    angles = torch.linspace(0.0, 50.0, 4, dtype=torch.float64)
    counts = (shear.small_launches, shear.fused3_launches)
    got = pipeline._derotate_frames(cube, angles, rot_mode="fft-small")
    monkeypatch.setenv("VIP_SMALL_SHEAR", "packed")
    ref = pipeline._derotate_frames(cube, angles, rot_mode="fft-small")
    assert torch.equal(got, ref)
    assert (shear.small_launches, shear.fused3_launches) == counts


@pytest.mark.parametrize("B,band,expect", [
    (50, 513 * 2048 * 8, 50),       # 512² frames: a chunk's 8.4 MB bands
    (125, 640 * 640 * 8, 125),      # fft-small 640² canvas, a whole chunk
    (1000, 513 * 2048 * 8, 63),     # a batch beyond the budget: groups
    (3, 640 * 640 * 8, 3),          # never more than the batch
    (7, 600 << 20, 1),              # at least one frame
])
def test_fused3_group_fits_the_scratch_budget(B, band, expect):
    G = shear._fused3_group(B, band)
    assert G == expect
    assert G * band <= shear._FUSED3_SCRATCH_BYTES or G == 1


def test_fused3_wrappers_keep_the_cpu_dtype():
    x = torch.zeros((2, 128, 128), dtype=torch.float64)
    a = torch.tensor([5.0, 95.0], dtype=torch.float64)
    assert shear.rotate_fft_small_fused3(x, a).dtype == torch.float64
    g = derotation._fft_rotate_geometry(32, 32)
    y = shear.rotate_fft_exact_fused3(x[:, :32, :32].contiguous(), a, g[0],
                                      *g[2:])
    assert y.dtype == torch.float64 and tuple(y.shape) == (2, 32, 32)

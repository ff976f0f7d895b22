"""Port's FFT rotation (ops/fft.py, ops/shear.py, preproc/derotation.py)
against vip_tpu on the CPU.

Float64 paths compute the same float64 FFTs in another library, so they
agree to ~1e-14; the bound is 1e-12 of max(|ref|, 1). At float32 the port
is held against vip_tpu's Pallas kernel ``rotate_fft_exact_fused`` in
interpret mode at 3e-5 of max(|ref|, 1), the bound vip_tpu's own
tests/test_pallas_shear.py:39 holds it to. The CUDA kernel H2 against its
plain version on a card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

import jax
import jax.numpy as jnp

from vip_tpu.ops import fft as jfft
from vip_tpu.ops.pallas_shear import rotate_fft_exact_fused as pallas_rotate
from vip_tpu.preproc import derotation as jder
from vip_tpu_torch.ops import fft, shear
from vip_tpu_torch.preproc import derotation

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


F64_TOL = 1e-12
F32_TOL = 3e-5


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.nanmax(np.abs(got - ref)) / max(np.nanmax(np.abs(ref)), 1.0)


def _frames(n, y, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, y, y)).astype(
        dtype)


_ANGLES = np.array([0.0, 45.0, 90.0, 135.0, 200.0, 270.0, 315.0, -30.0,
                    359.9])


@pytest.mark.parametrize("y", [32, 33, 64])
def test_exact_pruned_f64_vs_vip_tpu(y):
    geom = jder._fft_rotate_geometry(y, y)
    assert derotation._fft_rotate_geometry(y, y) == geom
    args = (geom[0],) + geom[2:]
    frames = _frames(len(_ANGLES), y, seed=y)
    ref = np.asarray(jax.jit(jfft.rotate_fft_exact_pruned,
                             static_argnums=tuple(range(2, 9)))(
        jnp.asarray(frames), jnp.asarray(_ANGLES), *args))
    got = fft.rotate_fft_exact_pruned(torch.from_numpy(frames),
                                      torch.from_numpy(_ANGLES), *args)
    assert got.dtype == torch.float64
    assert _err(got, ref) <= F64_TOL


def test_f32_vs_pallas_kernel_interpret():
    y = 64
    geom = jder._fft_rotate_geometry(y, y)
    args = (geom[0],) + geom[2:]
    frames = _frames(4, y, seed=7, dtype=np.float32)
    angles = np.array([13.7, 61.2, 158.9, 305.4], np.float32)
    ref = np.asarray(pallas_rotate(jnp.asarray(frames), jnp.asarray(angles),
                                   *args, interpret=True))
    before = shear.launches
    got = shear.rotate_fft_exact_fused(torch.from_numpy(frames),
                                       torch.from_numpy(angles), *args)
    assert shear.launches == before          # CPU: the plain version
    assert got.dtype == torch.float32
    assert _err(got, ref) <= F32_TOL


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decompose_rotation_vs_vip_tpu(dtype):
    angles = np.array([0, 45, 90, 135, 180, 225, 270, 315, 359.9, -45, -90,
                       -135, -359.9, 44.99, 45.01, 720.5], dtype)
    kj, dj = jfft.decompose_rotation(jnp.asarray(angles), jnp.dtype(dtype))
    kt, dt = fft.decompose_rotation(torch.from_numpy(angles),
                                    getattr(torch, np.dtype(dtype).name))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_rotate_fft_and_pipeline_vs_vip_tpu():
    frame = _frames(1, 24, seed=3)[0]
    angle = 100.0
    ref = np.asarray(jax.jit(jfft.rotate_fft)(jnp.asarray(frame), angle))
    got = fft.rotate_fft(torch.from_numpy(frame), angle)
    assert _err(got, ref) <= F64_TOL
    ref = np.asarray(jax.jit(jder.rotate_fft_pipeline)(jnp.asarray(frame),
                                                        angle))
    got = derotation.rotate_fft_pipeline(torch.from_numpy(frame), angle)
    assert _err(got, ref) <= F64_TOL


@pytest.mark.parametrize("mask", ["nan", "value"])
def test_cube_derotate_masks_vs_vip_tpu(mask):
    cube = _frames(6, 32, seed=11)
    angles = np.linspace(0, 50, 6)
    if mask == "nan":
        cube[2, 5:8, 9:12] = np.nan
        kw = {}
    else:
        cube[:, 14:18, 14:18] = 0.0
        kw = dict(mask_val=0)
    ref = np.asarray(jder.cube_derotate(cube, angles, **kw))
    got = derotation.cube_derotate(cube, angles, chunk=4, **kw)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert _err(got, ref) <= F64_TOL


def test_frame_rotate_vs_vip_tpu():
    frame = _frames(1, 31, seed=5)[0]
    frame[3, 4] = np.nan
    ref = jder.frame_rotate(frame, 33.0)
    got = derotation.frame_rotate(frame, 33.0)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert _err(got, ref) <= F64_TOL


@pytest.mark.parametrize("support", [None, (4, 25)])
def test_fast_batch_vs_vip_tpu(support):
    cube = _frames(5, 32, seed=13)     # odd count: one zero frame packed in
    angles = np.array([3.0, 50.0, 100.0, 190.0, -20.0])
    ref = np.asarray(jax.jit(jfft.rotate_fft_fast_batch,
                             static_argnames="support_rows")(
        jnp.asarray(cube), jnp.asarray(angles), support_rows=support))
    got = fft.rotate_fft_fast_batch(torch.from_numpy(cube),
                                    torch.from_numpy(angles),
                                    support_rows=support)
    assert _err(got, ref) <= F64_TOL


def test_cube_derotate_small_vs_vip_tpu():
    cube = _frames(6, 32, seed=17)
    angles = np.linspace(0, 50, 6)
    ref = np.asarray(jder.cube_derotate(cube, angles, imlib="vip-fft-small"))
    got = derotation.cube_derotate(cube, angles, imlib="vip-fft-small")
    assert _err(got, ref) <= F64_TOL


def test_shear_gate():
    sup = shear.fused_shear_supported
    for y in (32, 64, 128, 256, 512, 1024):
        assert sup(y, derotation._fft_rotate_geometry(y, y)[0])
    assert not sup(33, 132)                          # odd frame
    assert sup(96, 384)                              # mixed-radix canvas
    for y in (160, 192, 224, 288, 320, 352, 416, 448, 480):
        assert sup(y, derotation._fft_rotate_geometry(y, y)[0])
    assert not sup(100, 400)                         # odd part 25 > 15
    assert not sup(34, 136)                          # odd part 17 > 15
    assert not sup(2048, 8192)                       # canvas above 4096
    assert not sup(64, 256, torch.float64)           # dtype
    assert not sup(64, 256, torch.float32, "cpu")    # device

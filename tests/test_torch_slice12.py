"""Slice 12 of the port on the CPU: the last public functions of vip_tpu's
modules, each against vip_tpu (CPU, x64) on the same seeded numpy input,
the port in its float64 parity mode.

- ``psfsub.pca_fullfr.get_pca_coeffs`` with the PCs of vip_tpu's
  ``pca(full_output=True)``, for each scaling and central mask;
- ``preproc.derotation.tensor_rotate_fft`` on even and odd frames at the
  angles of ``chip_smoke.py`` phase 24, and ``tensor_fft_shear`` on both
  axes;
- ``ops.fft.fourier_shift_np``, bit for bit;
- ``config.parallel.tree_to_numpy`` and ``fits._native.available``.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

from vip_tpu.config import parallel as jparallel
from vip_tpu.fits import _native as jnative
from vip_tpu.ops import fft as jfft
from vip_tpu.preproc import derotation as jderot
from vip_tpu.psfsub import pca as jpca
from vip_tpu.psfsub import pca_fullfr as jpca_fullfr
from vip_tpu_torch.config import parallel
from vip_tpu_torch.fits import _native
from vip_tpu_torch.ops import fft
from vip_tpu_torch.preproc import derotation
from vip_tpu_torch.psfsub import pca_fullfr

TOL = 1e-10
# the angles of chip_smoke.py's phase 24: each quadrant's branch of the
# rot90 split, a residual of either sign
ANGLES = (0.0, 30.0, 60.0, 135.0, 300.0)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1.0)
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max()


@pytest.fixture(scope="module")
def adi_cube():
    rng = np.random.default_rng(1216)
    return rng.standard_normal((20, 32, 32)), np.linspace(0.0, 60.0, 20)


@pytest.mark.parametrize("mask_center_px", [None, 4])
@pytest.mark.parametrize("scaling", [None, "temp-mean", "spat-standard"])
def test_get_pca_coeffs(adi_cube, scaling, mask_center_px):
    cube, angles = adi_cube
    ncomp = 5
    pcs = np.asarray(jpca(cube, angles, ncomp=ncomp, scaling=scaling,
                          mask_center_px=mask_center_px, full_output=True,
                          verbose=False)[1])
    ref = np.asarray(jpca_fullfr.get_pca_coeffs(
        cube, pcs, ncomp, scaling, mask_center_px, verbose=False))
    got = pca_fullfr.get_pca_coeffs(cube, pcs, ncomp, scaling,
                                    mask_center_px, verbose=False)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == (ncomp, cube.shape[0])
    _close(got, ref)
    # a cube and PCs given as tensors give the same weights
    again = pca_fullfr.get_pca_coeffs(torch.from_numpy(cube),
                                      torch.from_numpy(pcs), ncomp, scaling,
                                      mask_center_px, verbose=False)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("size", [32, 31])
def test_tensor_rotate_fft(size, angle):
    frame = np.random.default_rng(size).standard_normal((1, size, size))
    ref = np.asarray(jderot.tensor_rotate_fft(frame, angle))
    got = derotation.tensor_rotate_fft(frame, angle)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    _close(got.numpy(), ref)
    if size % 2:
        # the zero row and column padded back onto the cropped frame
        assert not got[0, -1].any() and not got[0, :, -1].any()
    # a 2-d frame as a (1, y, x) one
    _close(derotation.tensor_rotate_fft(frame[0], angle).numpy(), ref)


@pytest.mark.parametrize("ax", [1, 2])
@pytest.mark.parametrize("size", [32, 31])
def test_tensor_fft_shear(size, ax):
    rng = np.random.default_rng(10 * size + ax)
    arr = rng.standard_normal((1, size, size)) \
        + 1j * rng.standard_normal((1, size, size))
    yy, xx = np.mgrid[0:size, 0:size]
    ramp = (yy if ax == 1 else xx) - size // 2
    ref = np.asarray(jderot.tensor_fft_shear(arr, ramp, 0.37, ax))
    got = derotation.tensor_fft_shear(arr, ramp, 0.37, ax)
    assert got.dtype == torch.complex128
    _close(got.numpy(), ref)


@pytest.mark.parametrize("shape,shift,npad", [
    ((32, 32), (0.3, -1.7), 2), ((31, 33), (-0.5, 0.5), 1),
    ((30, 31), (2.5, 0.25), 3), ((31, 31), (0.0, 0.0), 0)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_fourier_shift_np_is_vip_tpus(shape, shift, npad, dtype):
    rng = np.random.default_rng(sum(shape) + npad)
    array = (rng.standard_normal(shape) * 100).astype(dtype)
    ref = jfft.fourier_shift_np(array, *shift, npad)
    got = fft.fourier_shift_np(array, *shift, npad)
    assert got.dtype == ref.dtype
    assert got.tobytes() == ref.tobytes()


def test_fourier_shift_np_agrees_with_the_tensor_route():
    """The host twin and the port's ``fourier_shift`` compute one shift."""
    frame = np.random.default_rng(5).standard_normal((33, 33))
    _close(fft.fourier_shift_np(frame, -0.4, 1.3, 2),
           fft.fourier_shift(frame, -0.4, 1.3, 2).numpy())


def test_tree_to_numpy():
    rng = np.random.default_rng(7)
    leaves = [rng.standard_normal((3, 4)), rng.standard_normal(5),
              rng.standard_normal(())]
    tree = {"a": torch.from_numpy(leaves[0]),
            "b": [torch.from_numpy(leaves[1]),
                  (torch.from_numpy(leaves[2]), "name", 3)],
            "c": None}
    got = parallel.tree_to_numpy(tree)
    ref = jparallel.tree_to_numpy(
        {"a": leaves[0], "b": [leaves[1], (leaves[2], "name", 3)],
         "c": None})
    assert isinstance(got["a"], np.ndarray)
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    for g, r in ((got["a"], ref["a"]), (got["b"][0], ref["b"][0]),
                 (got["b"][1][0], ref["b"][1][0])):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, r)
    # leaves that are not tensors stay as they are
    assert got["b"][1][1:] == ("name", 3) and got["c"] is None
    # a tensor that requires grad comes back detached
    out = parallel.tree_to_numpy([torch.ones(2, requires_grad=True)])
    np.testing.assert_array_equal(out[0], np.ones(2))


def test_available(tmp_path, monkeypatch):
    assert isinstance(_native.available(), bool)
    assert _native.available() == jnative.available()
    assert _native.available()          # g++ builds the codec here
    broken = tmp_path / "fits_io.cpp"
    broken.write_text("int fits_decode_f32( {\n")
    monkeypatch.setattr(_native, "_SRC", str(broken))
    monkeypatch.setattr(_native, "_SO", str(tmp_path / "b" / "lib.so"))
    monkeypatch.setattr(_native, "_lib", None)
    assert _native.available() is False
    # the query adds no fallback: a load still raises
    with pytest.raises(RuntimeError, match="failed"):
        _native.load()

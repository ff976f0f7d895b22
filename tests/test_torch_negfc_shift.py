"""NEGFC's helpers in the port against vip_tpu, on the CPU at float64.

- The 'ndimage-fourier' shift (scipy's cyclic ``fourier_shift``, no pad):
  ``ops.fft.cyclic_fourier_shift`` against vip_tpu's
  ``ops.negfc_model.cyclic_fourier_shift``, ``frame_shift`` /
  ``cube_shift`` and ``cube_inject_companions`` / ``cube_planet_free``
  with imlib 'ndimage-fourier' against vip_tpu's scipy route: 1e-12 of
  max(|ref|, 1) (the same DFTs, the phase evaluated in another order).
  The cyclic shift is not the padded 'vip-fft' one: the two differ where
  the frame wraps.
- ``var.shapes.get_annular_wedge``: the same indices, for wedges inside
  [0, 360), across 360 and past it.
- ``fm.utils_mcmc``: 1e-12 (the same numpy).
"""

import numpy as np
import pytest
import threadpoolctl

import vip_tpu_torch
import vip_tpu.fm as jfm
from vip_tpu.fm import utils_mcmc as jmc
from vip_tpu.ops import negfc_model as jmodel
from vip_tpu.preproc import recentering as jrec
from vip_tpu.var import shapes as jshapes
import vip_tpu_torch.fm as tfm
from vip_tpu_torch.fm import utils_mcmc as tmc
from vip_tpu_torch.ops import fft as tfft
from vip_tpu_torch.preproc import recentering as trec
from vip_tpu_torch.var import shapes as tshapes

TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread for vip_tpu's LAPACK calls (see
    tests/test_torch_annular.py)."""
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _err(got, ref):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref))) / max(float(np.max(np.abs(ref))),
                                                   1.0)


@pytest.mark.parametrize("shape", [(15, 15), (16, 16), (13, 18)])
@pytest.mark.parametrize("dy,dx", [(0.3, -0.45), (-0.7, 0.0), (2.6, 1.2)])
def test_cyclic_fourier_shift(shape, dy, dx):
    rng = np.random.default_rng(1)
    frame = rng.standard_normal(shape)
    ref = np.asarray(jmodel.cyclic_fourier_shift(frame, dy, dx))
    assert _err(tfft.cyclic_fourier_shift(frame, dy, dx), ref) <= TOL
    # a batch of shifts of one frame: one FFT, the same stamps
    dys, dxs = np.array([[dy, dx], [dx, dy]]), np.array([[dx, dy], [dy, 0]])
    got = tfft.cyclic_fourier_shift(frame, dys, dxs)
    assert tuple(got.shape) == (2, 2) + shape
    for i in range(2):
        for j in range(2):
            ref = np.asarray(jmodel.cyclic_fourier_shift(frame, dys[i, j],
                                                         dxs[i, j]))
            assert _err(got[i, j], ref) <= TOL


def test_frame_and_cube_shift_ndimage_fourier():
    rng = np.random.default_rng(2)
    cube = rng.standard_normal((5, 21, 21))
    sy = np.array([0.3, -1.7, 0.0, 2.5, -0.25])
    sx = np.array([-0.6, 0.9, 1.0, -2.2, 0.5])
    ref = jrec.frame_shift(cube[0], 1.3, -0.4, imlib="ndimage-fourier")
    assert _err(trec.frame_shift(cube[0], 1.3, -0.4,
                                 imlib="ndimage-fourier"), ref) <= TOL
    ref = jrec.cube_shift(cube, sy, sx, imlib="ndimage-fourier")
    assert _err(trec.cube_shift(cube, sy, sx, imlib="ndimage-fourier"),
                ref) <= TOL
    # cyclic, not the padded 'vip-fft' shift: the wrapped edge differs
    padded = jrec.cube_shift(cube, sy, sx, imlib="vip-fft")
    assert np.max(np.abs(np.asarray(padded) - np.asarray(ref))) > 1e-2
    with pytest.raises(NotImplementedError):
        trec.cube_shift(cube, sy, sx, imlib="ndimage-interp")


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(3)
    cube = rng.standard_normal((6, 33, 33))
    angles = np.linspace(0, 40, 6)
    yy, xx = np.mgrid[:13, :13]
    psf = np.exp(-((yy - 6) ** 2 + (xx - 6) ** 2) / (2 * 1.7 ** 2))
    return cube, angles, psf


@pytest.mark.parametrize("case", ["plain", "transmission", "gradient"])
def test_inject_companions_ndimage_fourier(small, case):
    cube, angles, psf = small
    kw = dict(flevel=7.5, rad_dists=[9.3], theta=123.0,
              imlib="ndimage-fourier")
    if case != "plain":
        kw["transmission"] = np.array([[0.0, 5.0, 10.0, 30.0],
                                       [0.1, 0.5, 0.8, 1.0]])
        kw["radial_gradient"] = case == "gradient"
    ref = jfm.cube_inject_companions(cube, psf, angles, **kw)
    assert _err(tfm.cube_inject_companions(cube, psf, angles, **kw),
                ref) <= TOL


def test_planet_free_ndimage_fourier(small):
    cube, angles, psf = small
    p = (9.3, 123.0, 7.5)
    ref = jfm.cube_planet_free(p, cube, angles, psf, imlib="ndimage-fourier")
    assert _err(tfm.cube_planet_free(p, cube, angles, psf,
                                     imlib="ndimage-fourier"), ref) <= TOL


@pytest.mark.parametrize("inner,width,wedge", [
    (5, 4, (0, 360)), (8, 3.5, (30, 200)), (6, 6, (300, 420)),
    (4, 5, (370, 450)), (10.5, 2, (250.0, 275.5))])
@pytest.mark.parametrize("shape", [(31, 31), (32, 32)])
def test_get_annular_wedge(shape, inner, width, wedge):
    ref = jshapes.get_annular_wedge(np.zeros(shape), inner, width, wedge)
    got = tshapes.get_annular_wedge(shape, inner, width, wedge)
    assert len(ref[0]) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    frame = np.arange(np.prod(shape), dtype=float).reshape(shape)
    vals = tshapes.get_annular_wedge(frame, inner, width, wedge, mode="val")
    np.testing.assert_array_equal(vals.numpy(), frame[ref])


def test_utils_mcmc():
    rng = np.random.default_rng(4)
    chain = rng.standard_normal((6, 80, 3)).cumsum(axis=1)
    for j in range(3):
        assert abs(tmc.autocorr_test(chain[:, :, j])
                   - jmc.autocorr_test(chain[:, :, j])) <= TOL
        assert abs(tmc.autocorr(chain[:, :, j], c=3.0)
                   - jmc.autocorr(chain[:, :, j], c=3.0)) <= TOL
    series = np.vstack((chain[:, 10:30, 0].ravel(),
                        chain[:, 50:70, 0].ravel()))
    assert abs(tmc.gelman_rubin(series) - jmc.gelman_rubin(series)) <= TOL
    assert _err(tmc.gelman_rubin_from_chain(chain, 0.3),
                jmc.gelman_rubin_from_chain(chain, 0.3)) <= TOL
    assert _err(tmc.autocorr_func_1d(chain[0, :, 1]),
                jmc.autocorr_func_1d(chain[0, :, 1])) <= TOL
    assert tmc.next_pow_two(37) == jmc.next_pow_two(37) == 64
    taus = np.linspace(0.5, 9.0, 20)
    assert tmc.auto_window(taus, 2.0) == jmc.auto_window(taus, 2.0)

"""The port's PACO (``invprob.paco``) against vip_tpu, on the CPU at
float64, on the 8x24² fixture of tests/test_invprob_paco.py (a companion
at 7 px, 45°).

- The statistics helpers (``compute_statistics_at_pixel``,
  ``sample_covariance``, ``shrinkage_factor``, ``diagsample_covariance``,
  ``covariance``), ``get_rotated_pixel_coords`` and
  ``create_boolean_circular_mask``: 1e-12 (the mask exactly).
- ``FastPACO`` and ``FullPACO``: ``PACOCalc`` with and without the
  sub-pixel PSF bank, and ``run()``: the same pixels finite, a, b and the
  S/N map at 1e-8 of max|ref| (vip_tpu inverts by eigh or LU, the port
  by one batched LU); the dense ``compute_statistics`` at 1e-8.
- ``pixel_threshold_detection`` exactly; ``subpixel_threshold_detect``
  finds the companion; ``flux_estimate``, whose vip_tpu version raises
  (ROADMAP Queue 3), gives a finite estimate; a rescaling factor other
  than 1 raises, naming slice 7.
"""

import importlib

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

jp = importlib.import_module("vip_tpu.invprob.paco")
tp = importlib.import_module("vip_tpu_torch.invprob.paco")

torch.set_num_threads(1)

TOL = 1e-12
MAP_TOL = 1e-8


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


def paco_data():
    """tests/test_invprob_paco.py's cube: 8x24² of noise on a level of 5
    with a companion of peak 15 at 7 px, 45°, turning with the angles,
    and a 9x9 Gaussian PSF."""
    rng = np.random.default_rng(5)
    n, sz = 8, 24
    angs = np.linspace(0, 50, n)
    cube = rng.normal(0, 1, (n, sz, sz)) + 5
    yy, xx = np.mgrid[:sz, :sz]
    for k, a in enumerate(angs):
        th = np.deg2rad(-a)
        py = sz // 2 + 7 * np.sin(th + np.pi / 4)
        px = sz // 2 + 7 * np.cos(th + np.pi / 4)
        cube[k] += 15 * np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / 2.0)
    psf = np.exp(-((yy - sz / 2) ** 2 + (xx - sz / 2) ** 2) / 2.0)
    psf = psf[sz // 2 - 4:sz // 2 + 5, sz // 2 - 4:sz // 2 + 5].copy()
    return cube, angs, psf


@pytest.fixture(scope="module")
def data():
    return paco_data()


KW = dict(fwhm=2.0, pixscale=1.0, verbose=False)


def _phi0s():
    x0, y0 = np.meshgrid(np.arange(0, 24), np.arange(0, 24))
    return np.column_stack((x0.flatten(), y0.flatten()))


def _close(got, ref, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.abs(got[fin] - ref[fin]).max() <= tol * np.abs(ref[fin]).max()


def test_statistics_helpers():
    rng = np.random.default_rng(1)
    patch = rng.normal(0, 1, (10, 13))
    m_o, c_o = tp.compute_statistics_at_pixel(patch)
    m_r, c_r = jp.compute_statistics_at_pixel(patch)
    _close(m_o, m_r, TOL)
    _close(c_o, c_r, TOL * 1e3)
    S_o = tp.sample_covariance(patch, patch.mean(0), 10)
    S_r = jp.sample_covariance(patch, patch.mean(0), 10)
    _close(S_o, S_r, TOL)
    rho = tp.shrinkage_factor(S_o, 10)
    assert abs(float(rho) - jp.shrinkage_factor(S_r, 10)) <= TOL
    F = tp.diagsample_covariance(S_o)
    _close(F, jp.diagsample_covariance(S_r), TOL)
    _close(tp.covariance(rho, S_o, F),
           jp.covariance(jp.shrinkage_factor(S_r, 10), S_r,
                         jp.diagsample_covariance(S_r)), TOL)
    assert tp.compute_statistics_at_pixel(None) == (None, None)


def test_rotated_coords_and_mask():
    x, y = np.meshgrid(np.arange(-12, 12), np.arange(-12, 12))
    angs = np.linspace(0, 50, 8)
    for p0 in ((5, 7), (20, 3), (12, 12)):
        np.testing.assert_allclose(
            tp.get_rotated_pixel_coords(x, y, p0, angs),
            jp.get_rotated_pixel_coords(x, y, p0, angs), rtol=0, atol=TOL)
    for args in (((24, 24), 4, (10, 13)), ((24, 20), 3, None),
                 ((9, 9), None, None)):
        np.testing.assert_array_equal(
            tp.create_boolean_circular_mask(*args),
            jp.create_boolean_circular_mask(*args))


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("cls", ["FastPACO", "FullPACO"])
def test_paco_calc(data, cls, subpixel):
    cube, angs, psf = data
    ours = getattr(tp, cls)(cube=cube.copy(), angles=angs, psf=psf, **KW)
    theirs = getattr(jp, cls)(cube=cube.copy(), angles=angs, psf=psf, **KW)
    ao, bo = ours.PACOCalc(_phi0s(), use_subpixel_psf_astrometry=subpixel)
    at, bt = theirs.PACOCalc(_phi0s(),
                             use_subpixel_psf_astrometry=subpixel)
    _close(ao, at, MAP_TOL)
    _close(bo, bt, MAP_TOL)


def test_paco_run_and_detection(data):
    cube, angs, psf = data
    ours = tp.FastPACO(cube=cube.copy(), angles=angs, psf=psf, **KW)
    theirs = jp.FastPACO(cube=cube.copy(), angles=angs, psf=psf, **KW)
    snr_o, flux_o = ours.run()
    snr_t, flux_t = theirs.run()
    _close(snr_o, snr_t, MAP_TOL)
    _close(flux_o, flux_t, MAP_TOL)
    _close(ours.std, theirs.std, MAP_TOL)
    dense_o = ours.compute_statistics(None)
    dense_t = theirs.compute_statistics(None)
    for g, r in zip(dense_o, dense_t):
        _close(g, r, MAP_TOL)
    snr = snr_o.numpy()
    np.testing.assert_array_equal(
        ours.pixel_threshold_detection(snr, 3),
        theirs.pixel_threshold_detection(snr_t, 3))
    # the companion at 7 px, 45 deg of (12, 12), where the tracks start
    cy = cx = 12 + 7 * np.sin(np.pi / 4)
    yy, xx = ours.subpixel_threshold_detect(np.nan_to_num(snr), 3)
    assert any(abs(y - cy) <= 3 and abs(x - cx) <= 3
               for y, x in zip(np.atleast_1d(yy), np.atleast_1d(xx)))


def test_flux_estimate_and_what_raises(data):
    cube, angs, psf = data
    ours = tp.FastPACO(cube=cube.copy(), angles=angs, psf=psf, **KW)
    theirs = jp.FastPACO(cube=cube.copy(), angles=angs, psf=psf, **KW)
    pos = np.array([[16.9, 16.9]])
    # vip_tpu removes the model from each frame's patch once for every
    # frame, a (n, n, A) stack its statistics cannot take
    with pytest.raises(ValueError):
        theirs.flux_estimate(pos, eps=0.1, initial_est=[10.0])
    ests, stds, norm = ours.flux_estimate(pos, eps=0.1, initial_est=[10.0])
    assert np.isfinite(ests[0]) and np.isfinite(stds[0]) and ests[0] > 0
    assert np.isfinite(norm)
    ours.set_scale(2.0)
    with pytest.raises(NotImplementedError, match="slice 7"):
        ours.run()
    ours.set_scale(1.0)
    ours.rescale_cube_and_psf()

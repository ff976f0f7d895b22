"""The port's high-pass filters, polar conversions and Moffat/Airy fits
against vip_tpu, on the CPU at float64.

- ``frame_filter_highpass`` and ``cube_filter_highpass`` in the modes
  'laplacian-conv' (3, 5, 7), 'median-subt', 'gauss-subt' (with and
  without a mask), 'fourier-butter', 'hann' and 'psf-subt': 1e-10 of
  max(|ref|, 1) (the same float64 FFTs and convolutions). The cube is
  filtered in one batched pass; each frame must equal the frame filter.
- 'laplacian' at ksize 1, 3, 5, 7 against vip_tpu's ``cv2.Laplacian`` on
  float32 frames (OpenCV refuses a float64 one with a float32 output,
  ROADMAP Queue 3). Both give float32; the port convolves in float64 and
  rounds once (within half an ulp of each exact value), OpenCV
  accumulates in float32. Bounds against OpenCV: on a white-noise frame
  1 float32 ulp of max|ref| at ksize 1, 3 and 5, 2 ulps at 7 (OpenCV's
  7-tap float32 passes are that far from the exact value); on a frame
  with a bright smooth star, whose Laplacian cancels most of the frame's
  magnitude, OpenCV's own accumulation bound: float32 eps x the kernel's
  absolute sum x max|frame|.
- ``cart_to_pol`` / ``pol_to_cart`` with and without errors: 1e-12.
- ``fit_2dmoffat`` / ``fit_2dairydisk`` (the same scipy fit on the same
  host arrays) and ``normalize_psf(model='moff'|'airy')``: 1e-9.
- ``llsg(high_pass=)`` is in tests/test_torch_llsg.py, NEGFC's
  ``hp_filter`` in tests/test_torch_negfc_fmerit.py.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch
import vip_tpu.fm as jfm
from vip_tpu.var import coords as jco
from vip_tpu.var import filters as jfil
from vip_tpu.var import fit_2d as jfit
import vip_tpu_torch.fm as tfm
from vip_tpu_torch.var import coords as tco
from vip_tpu_torch.var import filters as tfil
from vip_tpu_torch.var import fit_2d as tfit

TOL = 1e-10
COORD_TOL = 1e-12
FIT_TOL = 1e-9
# float32 ulps of max|ref| of the 'laplacian' mode against OpenCV
LAPLACIAN_ULPS = {1: 1, 3: 1, 5: 1, 7: 2}


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


@pytest.fixture(scope="module")
def cube():
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[:36, :36]
    star = 50 * np.exp(-((yy - 18) ** 2 + (xx - 18) ** 2) / 30.0)
    return star + rng.standard_normal((3, 36, 36))


def _err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _psf():
    yy, xx = np.mgrid[:7, :7]
    return np.exp(-((yy - 3) ** 2 + (xx - 3) ** 2) / 3.0)


@pytest.mark.parametrize("mode,kw", [
    ("laplacian-conv", dict(kernel_size=3)),
    ("laplacian-conv", dict(kernel_size=5)),
    ("laplacian-conv", dict(kernel_size=7)),
    ("median-subt", dict(median_size=7)),
    ("gauss-subt", dict(fwhm_size=3)),
    ("gauss-subt", dict(fwhm_size=3, mask=True)),
    ("fourier-butter", dict(btw_cutoff=0.3, btw_order=3)),
    ("hann", dict(hann_cutoff=0.25)),
    ("hann", dict(hann_cutoff=5)),
    ("psf-subt", dict(psf=True)),
], ids=lambda v: v if isinstance(v, str) else "-".join(
    f"{k}={w}" for k, w in v.items()))
def test_highpass_modes_vs_vip_tpu(cube, mode, kw):
    kw = dict(kw)
    if kw.pop("psf", False):
        kw["psf"] = _psf()
    if kw.pop("mask", False):
        kw["mask"] = np.zeros(cube.shape[1:], bool)
        kw["mask"][10:14, 20:25] = True
    ref = jfil.cube_filter_highpass(cube, mode, verbose=False, **kw)
    got = tfil.cube_filter_highpass(cube, mode, verbose=False, **kw)
    assert got.shape == ref.shape
    assert _err(got, ref) <= TOL
    for i in range(cube.shape[0]):
        frame = tfil.frame_filter_highpass(cube[i], mode, **kw)
        assert _err(frame, jfil.frame_filter_highpass(cube[i], mode,
                                                      **kw)) <= TOL
        assert _err(frame, got[i]) <= TOL


def _laplacian_exact(frame, ksize):
    """The float64 value OpenCV's Laplacian approximates: the kernel
    correlated with -frame, reflect-101 border, in numpy."""
    k = tfil._laplacian_kernel(ksize)
    p = k.shape[0] // 2
    pad = np.pad(-np.asarray(frame, np.float64), p, mode="reflect")
    ny, nx = frame.shape
    return sum(k[i, j] * pad[i:i + ny, j:j + nx]
               for i in range(k.shape[0]) for j in range(k.shape[1]))


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_laplacian_vs_opencv(cube, ksize):
    rng = np.random.default_rng(ksize)
    kabs = np.abs(tfil._laplacian_kernel(ksize)).sum()
    noise = (100 * rng.standard_normal((32, 32))).astype(np.float32)
    star = (cube[0] * 10).astype(np.float32)
    for frame in (noise, star):
        ref = jfil.frame_filter_highpass(frame, "laplacian",
                                         kernel_size=ksize)
        got = tfil.frame_filter_highpass(frame, "laplacian",
                                         kernel_size=ksize)
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        got = got.numpy()
        # the port rounds the exact value once
        exact = _laplacian_exact(frame, ksize)
        assert np.all(np.abs(got - exact)
                      <= np.spacing(np.abs(exact).astype(np.float32)) / 2)
        # OpenCV is within its float32 accumulation error of it
        err = np.abs(got - ref).max()
        assert err <= np.finfo(np.float32).eps * kabs * np.abs(frame).max()
        if frame is noise:
            assert err <= LAPLACIAN_ULPS[ksize] * np.spacing(
                np.float32(np.abs(ref).max()))
    # a float64 cube, which vip_tpu's OpenCV call refuses: one pass,
    # rounded once, frame by frame the frame filter
    got3 = tfil.cube_filter_highpass(cube, "laplacian", kernel_size=ksize)
    assert got3.dtype == torch.float32
    for i in range(cube.shape[0]):
        exact = _laplacian_exact(cube[i], ksize)
        assert np.all(np.abs(got3[i].numpy() - exact)
                      <= np.spacing(np.abs(exact).astype(np.float32)) / 2)


def test_laplacian_rejects_even_ksize(cube):
    with pytest.raises(ValueError, match="odd"):
        tfil.frame_filter_highpass(cube[0], "laplacian", kernel_size=4)
    with pytest.raises(TypeError, match="not recognized"):
        tfil.cube_filter_highpass(cube, "nope")


def test_fft_round_trip(cube):
    spec = tfil.fft(cube[0])
    np.testing.assert_allclose(spec.numpy(), jfil.fft(cube[0]), rtol=0,
                               atol=TOL * np.abs(spec.numpy()).max())
    assert _err(tfil.ifft(spec), jfil.ifft(np.asarray(spec))) <= TOL
    np.testing.assert_array_equal(tfil._butter2d_lp((20, 24), 0.4, 3),
                                  jfil._butter2d_lp((20, 24), 0.4, 3))


@pytest.mark.parametrize("errors", [False, True])
@pytest.mark.parametrize("astro", [False, True])
def test_polar_conversions(errors, astro):
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-20, 20, 30), rng.uniform(-20, 20, 30)
    ex = dict(x_err=0.3, y_err=0.2) if errors else {}
    got = tco.cart_to_pol(x, y, cx=1.5, cy=-2.0, astro_convention=astro,
                          **ex)
    ref = jco.cart_to_pol(x, y, cx=1.5, cy=-2.0, astro_convention=astro,
                          **ex)
    assert len(got) == len(ref) == (4 if errors else 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=COORD_TOL, atol=COORD_TOL)
    ep = dict(r_err=0.4, theta_err=2.0) if errors else {}
    got = tco.pol_to_cart(ref[0], ref[1], cx=1.5, cy=-2.0,
                          astro_convention=astro, **ep)
    back = jco.pol_to_cart(ref[0], ref[1], cx=1.5, cy=-2.0,
                           astro_convention=astro, **ep)
    for g, r in zip(got, back):
        np.testing.assert_allclose(g, r, rtol=COORD_TOL, atol=COORD_TOL)


@pytest.mark.parametrize("fit", ["fit_2dmoffat", "fit_2dairydisk"])
def test_moffat_airy_fits(fit):
    yy, xx = np.mgrid[:19, :19]
    frame = 40 * tfit.moffat_2d(xx, yy, 1.0, 9.3, 8.7, 2.6, 1.8) \
        if fit == "fit_2dmoffat" else \
        40 * tfit.airydisk_2d(xx, yy, 1.0, 9.3, 8.7, 3.1)
    frame = frame + np.random.default_rng(2).normal(0, 0.05, frame.shape)
    np.testing.assert_array_equal(
        tfit.moffat_2d(xx, yy, 2.0, 9.3, 8.7, 2.6, 1.8),
        jfit.moffat_2d(xx, yy, 2.0, 9.3, 8.7, 2.6, 1.8))
    np.testing.assert_array_equal(
        tfit.airydisk_2d(xx, yy, 2.0, 9.3, 8.7, 3.1),
        jfit.airydisk_2d(xx, yy, 2.0, 9.3, 8.7, 3.1))
    for kw in (dict(), dict(crop=True, cropsize=11, cent=(9, 9)),
               dict(fwhm=5)):
        got = getattr(tfit, fit)(frame, full_output=True, debug=False, **kw)
        ref = getattr(jfit, fit)(frame, full_output=True, debug=False, **kw)
        assert list(got.columns) == list(ref.columns)
        np.testing.assert_allclose(got.to_numpy(), ref.to_numpy(),
                                   rtol=FIT_TOL, atol=FIT_TOL)
    assert np.allclose(getattr(tfit, fit)(frame, full_output=False,
                                          debug=False), (8.7, 9.3),
                       atol=0.05)


@pytest.mark.parametrize("model", ["moff", "airy"])
def test_normalize_psf_moffat_airy(model):
    yy, xx = np.mgrid[:21, :21]
    psf = 30 * tfit.moffat_2d(xx, yy, 1.0, 10.4, 9.7, 2.2, 2.0)
    for kw in (dict(fwhm="fit"), dict(fwhm="fit", size=15),
               dict(fwhm=4.0, force_odd=False)):
        got = tfm.normalize_psf(psf, model=model, full_output=True,
                                verbose=False, **kw)
        ref = jfm.normalize_psf(psf, model=model, full_output=True,
                                verbose=False, **kw)
        assert _err(got[0], ref[0]) <= FIT_TOL
        assert abs(got[1] - ref[1]) <= FIT_TOL * abs(ref[1])
        assert abs(float(got[2]) - float(ref[2])) <= FIT_TOL
    with pytest.raises(ValueError, match="not recognized"):
        tfm.normalize_psf(psf, model="lorentz", verbose=False)

"""Port's S/N, S/N maps and detection (``vip_tpu_torch.metrics`` and
``ops.apertures``) against vip_tpu on the CPU at float64.

- Exact photometry, ``snr``, ``snr_multi``, ``snrmap`` (exact, with
  known sources, and approximated), ``significance`` and
  ``frame_report``: the same float64 arithmetic in another library,
  within 1e-10 relative.
- The polar engine of ``snrmap_fast`` at float64 within 1e-10 relative.
  ``snrmap_fast`` itself runs in float32 in both packages (vip_tpu casts
  its input to float32): outside 1.5 FWHM of the center it agrees within
  1e-3 of max(|ref|, 1), the float32 rounding of a variance taken as
  S2/n − mean² over sums of squared fluxes (1.6e-4 measured on this
  frame); nearer, the three-aperture rings' variance is a float32
  cancellation that neither package resolves.
- ``detection`` in every candidate mode: the same coordinates.
- The golden S/N map pca_adi_snrmap (VIP's own map of the pca_adi golden
  frame) at ≤1e-5 max abs, as tests/test_golden.py:139-149.
"""

import importlib
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

import jax.numpy as jnp

from conftest import make_adi_cube
from gen_golden import GOLDEN_DIR, input_dataset_cached
from vip_tpu.ops import apertures as japt
import vip_tpu.psfsub as jps
from vip_tpu_torch.ops import apertures as tapt
from vip_tpu_torch.var import filters, fit_2d, shapes

# the packages' metrics/__init__ bind the names of these modules to
# functions of the same name
jdet = importlib.import_module("vip_tpu.metrics.detection")
jsnr = importlib.import_module("vip_tpu.metrics.snr_source")
tdet = importlib.import_module("vip_tpu_torch.metrics.detection")
tsnr = importlib.import_module("vip_tpu_torch.metrics.snr_source")

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


TOL = 1e-10
FAST_TOL = 1e-3


def _rel(got, ref):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.fixture(scope="module")
def frame():
    """A median-ADI frame of a synthetic cube with a planted companion at
    (24, 34) (vip_tpu's frame; float64)."""
    cube, angles = make_adi_cube(n=24, size=48)
    yy, xx = np.mgrid[:48, :48]
    for i, a in enumerate(np.deg2rad(angles)):
        py, px = 24 - 10 * np.sin(a), 24 + 10 * np.cos(a)
        cube[i] += 3 * np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / 5.77)
    return np.asarray(jps.median_sub(cube, angles, verbose=False))


def test_aperture_flux_vs_vip_tpu(frame):
    rng = np.random.default_rng(0)
    ys = rng.uniform(-2, 50, 40)       # some apertures off the frame edge
    xs = rng.uniform(-2, 50, 40)
    for r in (1.3, 2.0, 3.7):
        ref = np.asarray(japt.aperture_flux(jnp.asarray(frame), ys, xs, r))
        got = tapt.aperture_flux(frame, ys, xs, r)
        assert _rel(got, ref) <= TOL
    imgs = np.stack([frame, 2 * frame])
    ref = japt.aperture_flux_images(imgs, [ys[:5], ys[5:9]],
                                    [xs[:5], xs[5:9]], 2.0)
    got = tapt.aperture_flux_images(imgs, [ys[:5], ys[5:9]],
                                    [xs[:5], xs[5:9]], 2.0)
    assert [_rel(g, r) <= TOL for g, r in zip(got, ref)] == [True, True]


@pytest.mark.parametrize("kw", [
    {}, dict(exclude_negative_lobes=True),
    dict(exclude_theta_range=(-30, 60)), dict(full_output=True)])
def test_snr_vs_vip_tpu(frame, kw):
    for xy in ((34, 24), (30.5, 17.25), (14, 30)):
        ref = jsnr.snr(frame, xy, 4, **kw)
        got = tsnr.snr(frame, xy, 4, **kw)
        if kw.get("full_output"):
            for g, r in zip(got, ref):
                assert _rel(g, r) <= TOL
        else:
            assert abs(got - ref) <= TOL * max(abs(ref), 1.0)


def test_snr_second_array_vs_vip_tpu(frame):
    for use2alone in (False, True):
        ref = jsnr.snr(frame, (34, 24), 4, array2=0.5 * frame,
                       use2alone=use2alone)
        got = tsnr.snr(frame, (34, 24), 4, array2=0.5 * frame,
                       use2alone=use2alone)
        assert abs(got - ref) <= TOL * max(abs(ref), 1.0)


def test_snr_multi_vs_vip_tpu(frame):
    xs, ys = [34, 20, 10.5, 30], [24, 31, 25, 12.25]
    ref = jsnr.snr_multi(frame, xs, ys, 4)
    got = tsnr.snr_multi(frame, xs, ys, 4)
    assert _rel(got[0], ref[0]) <= TOL and _rel(got[1], ref[1]) <= TOL
    assert tsnr.snr_multi(frame, [], [], 4)[0].shape == (0,)


@pytest.mark.parametrize("kw", [
    {}, dict(exclude_negative_lobes=True), dict(approximated=True),
    dict(known_sources=(34, 24)), dict(known_sources=((34, 24), (14, 30))),
], ids=["exact", "neg_lobes", "approximated", "known1", "known2"])
def test_snrmap_vs_vip_tpu(frame, kw):
    ref = jsnr.snrmap(frame, 4, verbose=False, **kw)
    got = tsnr.snrmap(frame, 4, verbose=False, **kw)
    assert got.dtype == torch.float64 and tuple(got.shape) == frame.shape
    assert _rel(got, ref) <= TOL


def test_snrmap_second_array_and_zeros_vs_vip_tpu(frame):
    """array2, and exact zeros in the frame (vip_tpu leaves them out of the
    map's annulus)."""
    fr = frame.copy()
    fr[30:33, 10:14] = 0.0
    ref = jsnr.snrmap(fr, 4, array2=0.5 * fr, verbose=False)
    got = tsnr.snrmap(fr, 4, array2=0.5 * fr, verbose=False)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("neg", [False, True])
def test_polar_engine_float64_vs_vip_tpu(frame, neg):
    ref = np.asarray(japt.snrmap_polar_engine(
        jnp.asarray(frame), 4.0, exclude_negative_lobes=neg))
    got = tapt.snrmap_polar_engine(torch.as_tensor(frame), 4.0,
                                   exclude_negative_lobes=neg)
    assert _rel(got, ref) <= TOL


def test_snrmap_fast_float32_vs_vip_tpu(frame):
    ref = np.asarray(jsnr.snrmap_fast(frame, 4))
    got = tsnr.snrmap_fast(frame, 4)
    assert got.dtype == torch.float32 and tuple(got.shape) == frame.shape
    yy, xx = np.mgrid[:48, :48]
    far = np.hypot(yy - 24, xx - 24) >= 1.5 * 4
    err = np.abs(got.numpy().astype(float) - ref)[far].max()
    assert err <= FAST_TOL * max(np.abs(ref[far]).max(), 1.0)


@pytest.mark.parametrize("kw", [
    dict(snr=5.0, rad=20, fwhm=4),
    dict(snr=3.0, rad=12, fwhm=4, student_to_gauss=False),
    dict(snr=2.5, rad=30, fwhm=5, n_ap=20),
    dict(snr=1e3, rad=20, fwhm=4)])
def test_significance_vs_vip_tpu(kw):
    ref = jsnr.significance(verbose=False, **kw)
    got = tsnr.significance(verbose=False, **kw)
    assert abs(got - ref) <= TOL * max(abs(ref), 1.0)


def test_frame_report_vs_vip_tpu(frame):
    for xy in ((34, 24), None):
        ref = jsnr.frame_report(frame, 4, xy, verbose=False)
        got = tsnr.frame_report(frame, 4, xy, verbose=False)
        assert tuple(np.ravel(got[0])) == tuple(np.ravel(ref[0]))
        for g, r in zip(got[1:], ref[1:]):
            assert _rel(np.ravel(g), np.ravel(r)) <= TOL


def test_indep_ap_centers_exact():
    for kw in ({}, dict(exclude_negative_lobes=True), dict(no_gap=True),
               dict(exclude_theta_range=(10, 200))):
        ref = jsnr.indep_ap_centers(np.zeros((48, 48)), (34.0, 24.5), 4,
                                    **kw)
        got = tsnr.indep_ap_centers(np.zeros((48, 48)), (34.0, 24.5), 4,
                                    **kw)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("mode", ["lpeaks", "log", "dog", "snrmap",
                                  "snrmapf"])
def test_detection_vs_vip_tpu(frame, mode):
    kw = dict(fwhm=4, mode=mode, bkg_sigma=3, snr_thresh=2, plot=False,
              verbose=False)
    ref = jdet.detection(frame, **kw)
    got = tdet.detection(frame, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g, float),
                                   np.asarray(r, float), rtol=0, atol=1e-8)
    assert len(np.atleast_1d(got[0])) >= 1


def test_detection_table_and_matched_filter_vs_vip_tpu(frame):
    yy, xx = np.mgrid[:9, :9]
    psf = np.exp(-((yy - 4) ** 2 + (xx - 4) ** 2) / 5.77)
    kw = dict(fwhm=None, psf=psf, matched_filter=True, mode="lpeaks",
              bkg_sigma=3, snr_thresh=2, plot=False, verbose=False,
              full_output=True)
    ref = jdet.detection(frame, **kw)
    got = tdet.detection(frame, **kw)
    for col in ("y", "x", "px_snr"):
        np.testing.assert_allclose(np.asarray(got[col], float),
                                   np.asarray(ref[col], float), rtol=1e-10,
                                   atol=1e-8)


def test_peak_coordinates_and_masks_vs_vip_tpu(frame):
    assert tuple(tdet.peak_coordinates(frame, 4)) == \
        tuple(jdet.peak_coordinates(frame, 4))
    assert tuple(tdet.peak_coordinates(frame, 4, approx_peak=(24, 33),
                                       search_box=4)) == \
        tuple(jdet.peak_coordinates(frame, 4, approx_peak=(24, 33),
                                    search_box=4))
    cube = np.stack([frame, np.roll(frame, 3, axis=1)])
    for kw in ({}, dict(approx_peak=(24, 33), search_box=5,
                        channels_peak=True)):
        got = tdet.peak_coordinates(cube, 4, **kw)
        ref = jdet.peak_coordinates(cube, 4, **kw)
        assert str(got) == str(ref)
    m_ref = jdet.mask_source_centers(frame, 4, y=[24, 10], x=[34, 12])
    m_got = tdet.mask_source_centers(frame, 4, y=[24, 10], x=[34, 12])
    np.testing.assert_array_equal(m_got, m_ref)
    np.testing.assert_array_equal(tdet.mask_sources(m_got, 3),
                                  jdet.mask_sources(m_ref, 3))


def test_filters_and_fit_vs_vip_tpu(frame):
    from vip_tpu.var import filters as jfil
    from vip_tpu.var import fit_2d as jfit
    from vip_tpu.var import shapes as jshapes

    k = filters.gaussian_kernel_2d(1.7, 2.2)
    np.testing.assert_array_equal(k, jfil.gaussian_kernel_2d(1.7, 2.2))
    fr = frame.copy()
    fr[5:8, 5:8] = np.nan
    for kw in (dict(mode="gauss", fwhm_size=3), dict(mode="median",
                                                     median_size=3),
               dict(mode="gauss", fwhm_size=(2, 4), kernel_sz=9)):
        ref = jfil.frame_filter_lowpass(fr, **kw)
        got = filters.frame_filter_lowpass(fr, **kw).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        assert _rel(np.nan_to_num(got), np.nan_to_num(ref)) <= TOL
    yy, xx = np.mgrid[:15, :15]
    psf = 5 * np.exp(-((yy - 7.3) ** 2 + (xx - 6.8) ** 2) / 5.0) + 0.01
    ref = jfit.fit_2dgaussian(psf, full_output=False, debug=False)
    got = fit_2d.fit_2dgaussian(psf, full_output=False, debug=False)
    assert np.allclose(got, ref, rtol=0, atol=1e-8)
    sq = shapes.get_square(frame, 7, 20, 30, position=True)
    sq_ref = jshapes.get_square(frame, 7, 20, 30, position=True)
    np.testing.assert_array_equal(sq[0], sq_ref[0])
    assert sq[1:] == sq_ref[1:]
    for args in (((20, 30), 3.5, (48, 48)), ((4.2, 7.9), 2.0, (20, 30))):
        for g, r in zip(shapes.disk_coords(*args),
                        jshapes.disk_coords(*args)):
            np.testing.assert_array_equal(g, r)


def test_golden_snrmap():
    path = os.path.join(GOLDEN_DIR, "pca_adi_snrmap.npy")
    if not os.path.exists(path):
        pytest.skip("snrmap golden not generated")
    ds = input_dataset_cached()
    frame = np.load(os.path.join(GOLDEN_DIR, "pca_adi.npy"))
    mine = tsnr.snrmap(frame, ds["fwhm"], verbose=False).numpy()
    err = float(np.max(np.abs(mine - np.load(path))))
    assert err <= 1e-5, f"snrmap max abs err {err:.2e}"

"""The port's coordinates, shapes, 2-d fits, IUWT and deconvolution
(slice 8a of ``var``) against vip_tpu, on the CPU at float64.

- ``pol_to_eq``, ``QU_to_QUphi`` (vip_tpu's documented intent; the
  upstream function raises): 1e-12.
- ``mask_ellipse``, ``get_ellipse``, ``get_ell_annulus``, ``mask_roi``:
  equal masks, indices and values. ``create_ringed_spider_mask``: equal
  masks on several spider geometries; its even-odd polygon test against
  ``matplotlib.path.Path.contains_points`` on polygons whose edges pass
  through pixel centers (the pixels on the edges included).
- ``create_synth_psf`` (gauss, moff, airy, msdi): equal;
  ``fit_2d2gaussian`` (fixed and free negative Gaussian, the table):
  1e-9 (the same scipy fit).
- ``iuwt_*`` and ``cube_filter_iuwt``: 1e-10 of max(|ref|, 1);
  ``frame_deconvolution``: 1e-8 of max|ref| (an FFT convolution against
  scipy's).
"""

import numpy as np
import pytest
import torch
from matplotlib.path import Path

import vip_tpu_torch
import vip_tpu.var as jv
from vip_tpu.var import iuwt as jiuwt
import vip_tpu_torch.var as tv
from vip_tpu_torch.var import iuwt as tiuwt
from vip_tpu_torch.var import shapes as tsh

TOL = 1e-10
FIT_TOL = 1e-9
DECONV_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=TOL):
    got, ref = _np(got), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(17).standard_normal((40, 36)) + 3.0


@pytest.mark.parametrize("astro", (False, True))
def test_pol_to_eq(astro):
    ref = jv.pol_to_eq(12.0, 33.0, 0.4, 1.5, astro_convention=astro)
    out = tv.pol_to_eq(12.0, 33.0, 0.4, 1.5, astro_convention=astro)
    _close(np.ravel(out), np.ravel(ref), 1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(delta_x=1.5, delta_y=-2),
                                dict(scale_r2=True, north_convention=True)])
def test_qu_to_quphi(kw):
    rng = np.random.default_rng(2)
    Q, U = rng.standard_normal((2, 31, 30))
    for o, r in zip(tv.QU_to_QUphi(Q, U, **kw), jv.QU_to_QUphi(Q, U, **kw)):
        _close(o, r, 1e-12)


@pytest.mark.parametrize("mode", ("in", "out"))
def test_mask_ellipse(frame, mode):
    cube = np.stack([frame, -frame])
    for arr in (frame, cube):
        ref = jv.mask_ellipse(arr, 9, 5, 30, fillwith=-1, mode=mode)
        np.testing.assert_array_equal(
            _np(tv.mask_ellipse(arr, 9, 5, 30, fillwith=-1, mode=mode)), ref)
    np.testing.assert_array_equal(
        _np(tv.mask_ellipse(frame, 7, 4, 100, cy=15, cx=20,
                            output="bool_mask")),
        jv.mask_ellipse(frame, 7, 4, 100, cy=15, cx=20, output="bool_mask"))


@pytest.mark.parametrize("mode", ("ind", "val", "mask", "bool"))
def test_ellipses(frame, mode):
    for fn, args in (("get_ellipse", (11, 6, 25)),
                     ("get_ell_annulus", (11, 6, 25, 3))):
        for data in (frame, (40, 36)):
            ref = getattr(jv, fn)(data, *args, mode=mode)
            out = getattr(tv, fn)(data, *args, mode=mode)
            if mode == "ind":
                for o, r in zip(out, ref):
                    np.testing.assert_array_equal(o, r)
            else:
                np.testing.assert_array_equal(_np(out), ref)
    out = tv.get_ellipse(torch.from_numpy(frame), 8, 5, 60, mode="val")
    assert isinstance(out, torch.Tensor)


@pytest.mark.parametrize("mode", ("val", "mask", "bool", "ind"))
def test_mask_roi(mode):
    rng = np.random.default_rng(3)
    f = rng.standard_normal((51, 51))
    f[30, 33] = 0.0                     # a zero inside drops out, as VIP
    ref = jv.mask_roi(f, (33, 31), exc_radius=2, ann_width=4, inc_radius=6,
                      mode=mode)
    out = tv.mask_roi(f, (33, 31), exc_radius=2, ann_width=4, inc_radius=6,
                      mode=mode)
    if mode == "ind":
        for o, r in zip(out, np.where(jv.mask_roi(
                f, (33, 31), exc_radius=2, ann_width=4, inc_radius=6,
                mode="bool"))):
            np.testing.assert_array_equal(o, r)
    else:
        np.testing.assert_array_equal(_np(out), ref)


@pytest.mark.parametrize("args", [
    ((101, 101), 40, 5, 10, 0, 6), ((100, 100), 45, 8, 6, 17.3, 6),
    ((64, 80), 30, 0, 4, [10, 70, 130], 6), ((128, 128), 60, 10, 8, 45, 4),
    ((99, 99), 45, 4, 2, 0, 2), ((64, 64), 30, 3, 0, 90, 4)])
def test_ringed_spider_mask(args):
    ref = jv.create_ringed_spider_mask(*args)
    np.testing.assert_array_equal(tv.create_ringed_spider_mask(*args).numpy(),
                                  ref)


@pytest.mark.parametrize("verts", [
    [(2, 2), (2, 8), (8, 8), (8, 2)],              # pixels on every edge
    [(1, 1), (9, 4), (3, 9)],
    [(0, 0), (5, 5), (0, 10), (10, 10), (10, 0)],  # a notch, a vertex at a
    [(1.5, 2.5), (8.5, 2.5), (8.5, 7.5), (4.0, 4.0), (1.5, 7.5)]])
def test_polygon_pixels_as_matplotlib(verts):
    r, c = np.asarray(verts, dtype=float).T
    rr, cc = np.mgrid[:12, :11]
    inside = Path(np.column_stack([r, c])).contains_points(
        np.column_stack([rr.ravel(), cc.ravel()])).reshape(12, 11)
    for o, e in zip(tsh._polygon_coords(r, c, (12, 11)), np.nonzero(inside)):
        np.testing.assert_array_equal(o, e)


@pytest.mark.parametrize("kw", [
    dict(model="gauss", shape=(11, 9), fwhm=(3, 4.5), theta=20),
    dict(model="gauss", shape=(9, 9), x_mean=3.2, y_mean=4.7),
    dict(model="moff", shape=(15, 15), fwhm=5, alpha=2.0),
    dict(model="airy", shape=(15, 13), fwhm=4),
    dict(model="gauss", shape=(9, 9), fwhm=[3, 4, 5], msdi=True)])
def test_create_synth_psf(kw):
    np.testing.assert_array_equal(tv.create_synth_psf(**kw),
                                  jv.create_synth_psf(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(fix_neg=False, neg_amp=0.3),
                                dict(crop=True, cropsize=11, cent=(12, 11)),
                                dict(full_output=True)])
def test_fit_2d2gaussian(kw):
    pos = jv.create_synth_psf(shape=(25, 23), fwhm=5, x_mean=11.3,
                              y_mean=12.2)
    neg = 0.3 * jv.create_synth_psf(shape=(25, 23), fwhm=2.5, x_mean=11,
                                    y_mean=12)
    img = pos - neg + 1e-3 * np.random.default_rng(1).standard_normal(
        pos.shape)
    ref = jv.fit_2d2gaussian(img, debug=False, **kw)
    out = tv.fit_2d2gaussian(img, debug=False, **kw)
    if kw.get("full_output"):
        assert list(out.columns) == list(ref.columns)
        _close(out.to_numpy(), ref.to_numpy(), FIT_TOL)
    else:
        _close(np.asarray(out), np.asarray(ref), FIT_TOL)


@pytest.mark.parametrize("scale_adjust,store", ((0, False), (1, True),
                                                 (2, True)))
def test_iuwt_decomposition_and_recomposition(frame, scale_adjust, store):
    ref = jiuwt.iuwt_decomposition(frame, 5, scale_adjust,
                                   store_smoothed=store)
    out = tiuwt.iuwt_decomposition(frame, 5, scale_adjust,
                                   store_smoothed=store)
    if store:
        _close(out[0], ref[0])
        _close(out[1], ref[1])
        _close(tiuwt.iuwt_recomposition(out[0], scale_adjust,
                                        smoothed_array=out[1]),
               jiuwt.iuwt_recomposition(ref[0], scale_adjust,
                                        smoothed_array=ref[1]))
    else:
        _close(out, ref)
        _close(tiuwt.ser_iuwt_recomposition(out, scale_adjust, None),
               jiuwt.ser_iuwt_recomposition(ref, scale_adjust, None))


@pytest.mark.parametrize("scale", (0, 2, 5))
def test_a_trous_passes(frame, scale):
    f = np.array([0.1, 0.2, 0.4, 0.2, 0.1])
    # scale 5 spaces the taps by 32 and 64 px, past the frame's edges
    _close(tiuwt.ser_a_trous(frame, f, scale),
           jiuwt.ser_a_trous(frame, f, scale))
    _close(tiuwt.mp_a_trous(frame, f, scale, 2),
           jiuwt.mp_a_trous(frame, f, scale, 2))
    for rc in ("row", "col"):
        _close(tiuwt.mp_a_trous_kernel(frame, f, scale, 1, 7, rc),
               jiuwt.mp_a_trous_kernel(frame, f, scale, 1, 7, rc))
    _close(tiuwt.mp_iuwt_decomposition(frame, 4, 0, False, 2),
           jiuwt.mp_iuwt_decomposition(frame, 4, 0, False, 2))


@pytest.mark.parametrize("rel_coeff", (1, 3))
def test_cube_filter_iuwt(frame, rel_coeff):
    cube = np.stack([frame, frame[::-1] * 0.5, frame ** 2])
    ref = jv.cube_filter_iuwt(cube, coeff=5, rel_coeff=rel_coeff,
                              full_output=True)
    out = tv.cube_filter_iuwt(cube, coeff=5, rel_coeff=rel_coeff,
                              full_output=True)
    _close(out[0], ref[0])
    _close(out[1], ref[1])
    _close(tiuwt.iuwt_decomposition_batch(cube, 4),
           jiuwt.iuwt_decomposition_batch(cube, 4))


@pytest.mark.parametrize("psf_shape", ((21, 21), (8, 11)))
def test_frame_deconvolution(frame, psf_shape):
    psf = jv.create_synth_psf(shape=psf_shape[::-1], fwhm=3)
    psf /= psf.sum()
    img = np.abs(frame)
    ref = jv.frame_deconvolution(img, psf, n_it=30)
    out = tv.frame_deconvolution(img, psf, n_it=30).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=DECONV_TOL * np.abs(ref).max())


def test_var_namespace_has_filters_and_fits():
    """ROADMAP Q3-1: ``vip_tpu_torch.var`` re-exports the filters and the
    2-d fits, as ``vip_tpu.var`` does."""
    for name in ("frame_filter_highpass", "cube_filter_lowpass",
                 "fit_2dgaussian", "fit_2dmoffat", "gaussian_kernel_2d",
                 "fft", "ifft", "frame_deconvolution", "cube_filter_iuwt"):
        assert callable(getattr(tv, name)), name
    from vip_tpu_torch.var import filters
    assert tv.fft is filters.fft and tv.ifft is filters.ifft

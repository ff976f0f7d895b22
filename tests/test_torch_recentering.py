"""The port's recentering routines (``preproc.recentering``) against
vip_tpu, on the CPU at float64: 2-d fits, satellite spots, the Radon
transform and speckle cross-correlation.

- ``cube_recenter_2dfit`` ('gauss', 'moff', 'airy', '2gauss' with a fixed
  negative Gaussian): fitted shifts within 1e-6 px, frames within 1e-8 of
  max(|ref|, 1). '2gauss' with ``fix_neg=False`` raises KeyError in
  vip_tpu (its fit's table lacks the negative Gaussian's columns, ROADMAP
  Queue 3); the port returns vip_tpu's 13-column tuple, its centroids
  those of vip_tpu's own ``fit_2d2gaussian``.
- ``frame_center_satspots`` and ``cube_recenter_satspots`` (``lbda``
  rescaling of the spots): the same. With ``filter_freq`` the filtered
  frames (vip_tpu's quirk: the frame shifted is the filtered one) within
  1e-8, the shifts within 1e-6 px.
- ``radon`` (the whole sinogram), ``_radon_costf`` (one grid point) and
  the port's column-only ``_radon_costs`` against the full ``radon`` row:
  the cost grid within 1e-10 relative; one full ``frame_center_radon``
  (25 grid points, one iteration; vip_tpu returns the mirror image of the
  star's position, ROADMAP Queue 3); ``cube_recenter_radon`` against the
  port's per-frame loop; the ValueError of a null first shift.
- ``_fit_2dannulus`` (the flat argmax over [x, y], one radius and a
  radius search) and ``cube_recenter_via_speckles`` (plain, and
  ``recenter_median`` with 'gaus' and 'ann'; the 'median-subt' high-pass
  of an even ``median_size`` of 12 on the way): equal.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as nd_shift

import vip_tpu_torch
from vip_tpu.preproc import recentering as jrec
from vip_tpu.var import filters as jfilt
from vip_tpu.var.fit_2d import fit_2d2gaussian as j2g
from vip_tpu_torch.preproc import recentering as trec
from vip_tpu_torch.var import filters as tfilt
from vip_tpu_torch.var.fit_2d import create_synth_psf

FIT_TOL = 1e-6
FRAME_TOL = 1e-8
COST_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=FRAME_TOL):
    ref = np.asarray(ref, dtype=float)
    got = _np(got).astype(float)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.nanmax(np.abs(ref)), 1.0))


def _shifts(got, ref, tol=FIT_TOL):
    np.testing.assert_allclose(np.ravel(got), np.ravel(ref), rtol=0,
                               atol=tol)


@pytest.fixture(scope="module")
def star_cube():
    """6 frames of 32² with a Moffat star jittered by up to 1.5 px."""
    rng = np.random.default_rng(3)
    out = np.empty((6, 32, 32))
    for i, (dy, dx) in enumerate(rng.uniform(-1.5, 1.5, (6, 2))):
        out[i] = create_synth_psf("moff", (32, 32), amplitude=100,
                                  x_mean=16 + dx, y_mean=16 + dy, fwhm=4) \
            + rng.standard_normal((32, 32))
    return out


@pytest.mark.parametrize("model", ["gauss", "moff", "airy", "2gauss"])
def test_cube_recenter_2dfit(star_cube, model):
    kw = dict(fwhm=4, subi_size=9, model=model, full_output=True,
              verbose=False, plot=False, offset=(0.2, -0.1))
    if model == "2gauss":
        kw.update(fix_neg=True, xy=(16.0, 16.0))
    np.random.seed(0)
    theirs = jrec.cube_recenter_2dfit(star_cube, **kw)
    np.random.seed(0)
    ours = trec.cube_recenter_2dfit(star_cube, **kw)
    assert isinstance(ours[0], torch.Tensor)
    _shifts(ours[1], theirs[1])
    _shifts(ours[2], theirs[2])
    _close(ours[0], theirs[0])


def test_cube_recenter_2dfit_threshold_and_negative(star_cube):
    kw = dict(fwhm=4, subi_size=9, model="gauss", full_output=True,
              verbose=False, plot=False, threshold=True, sigfactor=1)
    np.random.seed(5)
    theirs = jrec.cube_recenter_2dfit(star_cube, **kw)
    np.random.seed(5)
    ours = trec.cube_recenter_2dfit(star_cube, **kw)
    _shifts(ours[1], theirs[1])
    kw.update(threshold=False, negative=True)
    theirs = jrec.cube_recenter_2dfit(-star_cube, **kw)
    ours = trec.cube_recenter_2dfit(-star_cube, **kw)
    _shifts(ours[1], theirs[1])
    _shifts(ours[2], theirs[2])


def test_2gauss_free_negative(star_cube):
    """vip_tpu's '2gauss' with ``fix_neg=False`` reads columns its fit
    does not return (a reference fault, ROADMAP Queue 3); the port gives
    vip_tpu's tuple, the positive centroids those of vip_tpu's fit."""
    kw = dict(fwhm=4, subi_size=9, model="2gauss", fix_neg=False,
              xy=(16, 16), full_output=True, verbose=False, plot=False)
    with pytest.raises(KeyError):
        jrec.cube_recenter_2dfit(star_cube, **kw)
    ours = trec.cube_recenter_2dfit(star_cube, **kw)
    assert len(ours) == 13
    for i in range(star_cube.shape[0]):
        cy, cx = j2g(star_cube[i], crop=True, cent=(16, 16), cropsize=10,
                     fwhm_neg=0.8 * 4, fwhm_pos=2 * 4, fix_neg=False,
                     sigfactor=2, debug=False)
        _shifts(16 - ours[1][i], cy)
        _shifts(16 - ours[2][i], cx)


@pytest.fixture(scope="module")
def satspots_cube():
    """3 frames of 48² with four Moffat spots on the 'x' diagonals at 17 px,
    the pattern jittered by up to 0.7 px and scaled by 1, 1.01, 1.02."""
    rng = np.random.default_rng(8)
    n, s, c = 3, 48, 24
    lbda = [1.0, 1.01, 1.02]
    cube = 0.1 * rng.standard_normal((n, s, s))
    for i in range(n):
        dy, dx = rng.uniform(-0.7, 0.7, 2)
        for sy, sx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            cube[i] += create_synth_psf(
                "moff", (s, s), amplitude=50, fwhm=3,
                x_mean=c + dx + sx * 12 * lbda[i],
                y_mean=c + dy + sy * 12 * lbda[i])
    xy = ((c - 12, c - 12), (c + 12, c - 12), (c - 12, c + 12),
          (c + 12, c + 12))
    return cube, xy, lbda


@pytest.mark.parametrize("fit_type", ["moff", "gaus"])
def test_cube_recenter_satspots(satspots_cube, fit_type):
    cube, xy, lbda = satspots_cube
    kw = dict(subi_size=7, plot=False, verbose=False, full_output=True,
              fit_type=fit_type, lbda=lbda)
    np.random.seed(1)
    theirs = jrec.cube_recenter_satspots(cube, xy, **kw)
    np.random.seed(1)
    ours = trec.cube_recenter_satspots(cube, xy, **kw)
    assert isinstance(ours[0], torch.Tensor)
    for k in range(1, 5):
        _shifts(ours[k], theirs[k])
    _close(ours[0], theirs[0])
    np.random.seed(1)
    theirs = jrec.frame_center_satspots(cube[0], xy, subi_size=7,
                                        shift=True, fit_type=fit_type,
                                        verbose=False)
    np.random.seed(1)
    ours = trec.frame_center_satspots(cube[0], xy, subi_size=7, shift=True,
                                      fit_type=fit_type, verbose=False)
    _close(ours[0], theirs[0])
    for k in range(1, 5):
        _shifts(ours[k], theirs[k])


def test_satspots_filtered_frame_is_shifted(satspots_cube):
    """With ``filter_freq`` the frame returned shifted is the filtered one
    (vip_tpu recentering.py:276-279): the port's batched filters give
    vip_tpu's filtered frames, the fits the same shifts."""
    cube, xy, _ = satspots_cube
    ff = (3, 1)
    filt = jfilt.frame_filter_lowpass(jfilt.frame_filter_highpass(
        cube[0], mode="gauss-subt", fwhm_size=ff[0]), fwhm_size=ff[1])
    ours_f, _, _ = trec._satspots_centroids(
        torch.from_numpy(cube[:1]), [xy], 7, 6, "moff", ff, False)
    _close(ours_f[0], filt)
    np.random.seed(2)
    theirs = jrec.frame_center_satspots(cube[0], xy, subi_size=7,
                                        filter_freq=ff, verbose=False)
    np.random.seed(2)
    ours = trec.frame_center_satspots(cube[0], xy, subi_size=7,
                                      filter_freq=ff, verbose=False)
    _shifts(ours, theirs)
    ours_rec = trec.frame_center_satspots(cube[0], xy, subi_size=7,
                                          filter_freq=ff, shift=True,
                                          verbose=False)
    _close(ours_rec[0], trec.frame_shift(ours_f[0], ours_rec[1],
                                         ours_rec[2]))


@pytest.fixture(scope="module")
def radon_frame():
    """A 41² speckle frame with four spots on the 'x' diagonals, its center
    moved by (0.6, -0.4) px."""
    rng = np.random.default_rng(4)
    s, c = 41, 20
    frame = 0.2 * rng.standard_normal((s, s))
    for sy, sx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        frame += create_synth_psf("moff", (s, s), amplitude=20, fwhm=3,
                                  x_mean=c + sx * 9, y_mean=c + sy * 9)
    return nd_shift(frame, (0.6, -0.4), order=3)


def test_radon_sinogram(radon_frame):
    theta = np.linspace(0, 180, 23)
    _close(trec.radon(torch.from_numpy(radon_frame[:31, :31]), theta),
           jrec.radon(radon_frame[:31, :31], theta), 1e-12)


GRID = [(y, x) for y in np.linspace(-1, 1, 5) for x in np.linspace(-1, 1, 5)]


@pytest.mark.parametrize("cfg,radint", [("x", 0), (None, 3), ("custom", 2)])
def test_radon_cost_grid(radon_frame, cfg, radint):
    """The column-only cost of every grid point at once against vip_tpu's
    ``_radon_costf`` (a few points) and the port's full-sinogram one (all
    25)."""
    frame = radon_frame[5:36, 5:36]
    cent = 15
    kw = dict(satspots_cfg=cfg, theta_0=10, delta_theta=4)
    ours = trec._radon_costs(torch.from_numpy(frame), cent, radint, GRID,
                             **kw)
    full = np.array([trec._radon_costf(torch.from_numpy(frame), cent,
                                       radint, c, **kw) for c in GRID])
    np.testing.assert_allclose(ours, full, rtol=COST_TOL, atol=0)
    for k in (0, 7, 12, 24):
        theirs = jrec._radon_costf(frame, cent, radint, GRID[k], **kw)
        np.testing.assert_allclose(ours[k], theirs, rtol=COST_TOL, atol=0)


def test_satspots_theta():
    for cfg in ("+", "x", "custom"):
        np.testing.assert_array_equal(
            trec._satspots_theta(cfg, 12, 4),
            jrec._satspots_theta(cfg, 12, 4))
    with pytest.raises(ValueError):
        trec._satspots_theta("y", 0, 5)


RADON_KW = dict(cropsize=31, hsize_ini=1.0, step_ini=0.5, n_iter=1,
                tol=0.001, satspots_cfg="x", full_output=True,
                verbose=False, plot=False)


@pytest.fixture(scope="module")
def radon_theirs(radon_frame):
    # one vip_tpu search: 25 grid points, one iteration (~5 s of CPU)
    return jrec.frame_center_radon(radon_frame, **RADON_KW)


def test_frame_center_radon(radon_frame, radon_theirs):
    """The same search; vip_tpu returns the mirror image of the star's
    position about the frame center (it adds the summed shifts to the
    center, ROADMAP Queue 3), the port the star's."""
    ours = trec.frame_center_radon(radon_frame, **RADON_KW)
    _shifts(ours[0], 2 * 20 - radon_theirs[0])
    _shifts(ours[1], 2 * 20 - radon_theirs[1])
    _shifts(ours[:2], (20.6, 19.6), 0.1)
    _shifts(ours[2], radon_theirs[2])
    cost = radon_theirs[3]
    np.testing.assert_allclose(ours[3], cost, rtol=0,
                               atol=COST_TOL * np.abs(cost).max())


def test_frame_center_radon_argmax_and_null_shift(radon_frame):
    kw = dict(RADON_KW, gauss_fit=False)
    y, x, dyx, cost = trec.frame_center_radon(radon_frame, **kw)
    k = int(np.argmax(cost))
    assert (20 - y, 20 - x) == GRID[k]
    assert dyx == (0.5, 0.5)
    with pytest.raises(ValueError, match="Null shifts"):
        trec.frame_center_radon(radon_frame, **dict(kw, tol=10))


def test_cube_recenter_radon_is_the_per_frame_loop(radon_frame):
    cube = np.stack([radon_frame, nd_shift(radon_frame, (0.3, 0.2),
                                           order=3)])
    kw = dict(cropsize=31, hsize_ini=1.0, step_ini=0.5, n_iter=2, tol=0.001,
              satspots_cfg="x")
    rec, y, x, dyx = trec.cube_recenter_radon(cube, full_output=True,
                                              verbose=False, **kw)
    for i in range(2):
        fy, fx, fdyx, _ = trec.frame_center_radon(
            cube[i], full_output=True, verbose=False, plot=False, **kw)
        assert (y[i], x[i]) == (fy - 20, fx - 20)
        assert tuple(dyx[i]) == fdyx
        assert torch.equal(rec[i], trec.frame_shift(cube[i], -y[i], -x[i]))
    # the star moved by (0.3, 0.2) px between the two frames
    _shifts((y[1] - y[0], x[1] - x[0]), (0.3, 0.2), 0.1)


@pytest.fixture(scope="module")
def speckle_cube():
    """5 frames of 40²: a smooth speckle pattern and a Moffat star shifted
    together by up to 1.5 px, plus white noise."""
    rng = np.random.default_rng(3)
    base = gaussian_filter(3 * rng.standard_normal((40, 40)), 1.5) * 20
    base += create_synth_psf("moff", (40, 40), amplitude=100, fwhm=4)
    return np.stack([nd_shift(base, rng.uniform(-1.5, 1.5, 2), order=3)
                     + 0.1 * rng.standard_normal((40, 40))
                     for _ in range(5)])


@pytest.mark.parametrize("sampl_rad", [None, 0.2])
def test_fit_2dannulus(speckle_cube, sampl_rad):
    sub = speckle_cube[0, 8:31, 8:31]
    theirs = jrec._fit_2dannulus(sub, fwhm=4, sampl_cen=0.1,
                                 sampl_rad=sampl_rad)
    ours = trec._fit_2dannulus(torch.from_numpy(sub), fwhm=4, sampl_cen=0.1,
                               sampl_rad=sampl_rad)
    assert tuple(ours) == tuple(theirs)


@pytest.mark.parametrize("case", ["plain", "gaus", "ann"])
def test_cube_recenter_via_speckles(speckle_cube, case):
    kw = dict(alignment_iter=2 if case == "plain" else 1, subframesize=25,
              plot=False, full_output=True)
    if case != "plain":
        kw.update(recenter_median=True, fit_type=case, negative=False,
                  upsample_factor=10)
    theirs = jrec.cube_recenter_via_speckles(speckle_cube, **kw)
    ours = trec.cube_recenter_via_speckles(speckle_cube, **kw)
    assert len(ours) == len(theirs) == 5
    for k in (0, 1, 2):
        _close(ours[k], theirs[k])
    for k in (3, 4):
        _shifts(ours[k], theirs[k], 1e-12)


def test_median_subt_even_size(speckle_cube):
    """The speckle path's 'median-subt' of ``median_size = int(fwhm *
    max_spat_freq)`` = 12 (an even window): on the device, bit-equal to
    vip_tpu's host scipy."""
    theirs = np.asarray(jfilt.cube_filter_highpass(
        speckle_cube, "median-subt", median_size=12, verbose=False))
    ours = tfilt.cube_filter_highpass(torch.from_numpy(speckle_cube),
                                      "median-subt", median_size=12,
                                      verbose=False)
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_only_fft_imlibs_name_slice_8c(star_cube):
    with pytest.raises(NotImplementedError, match="slice 8c"):
        trec.cube_recenter_2dfit(star_cube, imlib="opencv", verbose=False,
                                 plot=False)

"""The rest of slice 7 against vip_tpu, on the CPU at float64: 4-d
``median_sub`` and ``xloci``, the 4-d throughput and contrast curve,
PACO's rescaling, and NEGFC on 4-d cubes.

Bounds: 1e-8 of max(|ref|, 1) for frames (the same float32 zoom canvas,
float64 FFTs and LAPACK in two libraries); the contrast curve's columns
1e-6 relative, as tests/test_torch_contrcurve.py; NEGFC log-probabilities
and χ² 1e-8 relative, as tests/test_torch_negfc_model.py.

PACO: vip_tpu computes the resampled cube and drops it
(vip_tpu/invprob/paco.py:142), so the port's resampled cube is held to
vip_tpu's ``cube_px_resampling``, and the port's maps to vip_tpu's PACO
run on that cube with ``rescaling_factor=1`` and the resampled PSF, FWHM
and pixel scale.

NEGFC: vip_tpu's ``get_mu_and_sigma`` puts r_guess in the theta of a
multi-flux companion (vip_tpu/fm/negfc_fmerit.py:275); the port puts
theta_guess there. The two agree when theta_guess equals r_guess, and a
test shows the difference otherwise.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from scipy.ndimage import gaussian_filter

import vip_tpu_torch
import vip_tpu.fm as jfm
import vip_tpu.metrics as jm
import vip_tpu.psfsub as jps
from vip_tpu.ops import negfc_model as jmodel
from vip_tpu.preproc.rescaling import cube_px_resampling as jresample
from vip_tpu.preproc.rescaling import frame_px_resampling as jresample_fr
from vip_tpu.preproc.rescaling import frame_rescaling as jrescale
import vip_tpu_torch.fm as tfm
import vip_tpu_torch.metrics as tm
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch import convert
from vip_tpu_torch.metrics.contrcurve import _contrast_curve
from vip_tpu_torch.ops import negfc_model as tmodel

jp = importlib.import_module("vip_tpu.invprob.paco")
tp = importlib.import_module("vip_tpu_torch.invprob.paco")

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """Numpy input runs on the CPU in float64 for this module, with one
    BLAS thread (vip_tpu's LAPACK calls beside other test workers)."""
    vip_tpu_torch.set_device("cpu")
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(got, ref):
    got = np.asarray(_np(got), np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    return np.abs(got[fin] - ref[fin]).max() / max(np.abs(ref[fin]).max(),
                                                   1.0)


def _ifs(z=4, n=8, size=40, seed=9, rot=40.0, span=0.3):
    """tests/test_pca_4d.py's ``ifs_cube``: speckles scaled with λ."""
    rng = np.random.default_rng(seed)
    wl = np.linspace(1.0, 1.0 + span, z)
    scal = wl[-1] / wl
    speck = gaussian_filter(rng.standard_normal((size, size)), 2.0) * 5
    cube = np.empty((z, n, size, size))
    for ch in range(z):
        sp = jrescale(speck.copy(), scale=1 / scal[ch])
        for fr in range(n):
            cube[ch, fr] = sp + gaussian_filter(
                rng.standard_normal((size, size)), 1.0) * 0.3
    return cube, np.linspace(0, rot, n), scal


@pytest.fixture(scope="module")
def ifs_cube():
    return _ifs()


# ---------------------------------------------------------------------------
# median_sub
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(mode="fullfr"),
    dict(mode="fullfr", sdi_only=True, flux_sc_list=[1.0, 0.9, 1.1, 1.2]),
    dict(mode="annular", radius_int=6, asize=4, delta_sep=0.1,
         delta_rot=0.3, nframes=None),
    dict(mode="annular", radius_int=6, asize=4, delta_sep=(0.1, 0.3),
         delta_rot=0.3, nframes=2, collapse="mean"),
], ids=["fullfr", "sdi-only-flux", "annular", "annular-nframes-mean"])
def test_median_sub_4d(ifs_cube, kw):
    cube, angles, scal = ifs_cube
    ref = jps.median_sub(cube.copy(), angles, scale_list=scal, fwhm=4,
                         full_output=True, verbose=False, **kw)
    got = tps.median_sub(cube.copy(), angles, scale_list=scal, fwhm=4,
                         full_output=True, verbose=False, **kw)
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


def test_median_sub_4d_params_object(ifs_cube):
    from vip_tpu.psfsub.medsub import MEDIAN_SUB_Params as JMed

    cube, angles, scal = ifs_cube
    jp_ = JMed(cube=cube, angle_list=angles, scale_list=scal, fwhm=4,
               verbose=False)
    tp_ = convert.params_from_numpy(jp_)
    assert isinstance(tp_.scale_list, torch.Tensor)
    assert _err(tps.median_sub(algo_params=tp_),
                jps.median_sub(algo_params=jp_)) < TOL


# ---------------------------------------------------------------------------
# xloci
# ---------------------------------------------------------------------------

LOCI = dict(fwhm=4, asize=8, radius_int=4, delta_sep=0.1, delta_rot=0.3,
            n_segments=1, verbose=False)


@pytest.mark.parametrize("kw", [
    dict(adimsdi="skipadi"),
    dict(adimsdi="single"),
    dict(adimsdi="double"),
    dict(adimsdi="double", dist_threshold=90, metric="euclidean"),
    dict(adimsdi="single", solver="nnls"),
], ids=["skipadi", "single", "double", "double-distance", "single-nnls"])
def test_xloci_4d(ifs_cube, kw):
    cube, angles, scal = ifs_cube
    kw = dict(LOCI, **kw)
    ref = jps.xloci(cube.copy(), angles, scale_list=scal,
                    full_output=True, **kw)
    got = tps.xloci(cube.copy(), angles, scale_list=scal,
                    full_output=True, **kw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


def test_xloci_4d_params_object(ifs_cube):
    from vip_tpu.psfsub.loci import XLOCI_Params as JLoci

    cube, angles, scal = ifs_cube
    jl = JLoci(cube=cube, angle_list=angles, scale_list=scal,
               adimsdi="double", **LOCI)
    tl = convert.params_from_numpy(jl)
    assert type(tl).__name__ == "XLOCI_Params"
    assert _err(tps.xloci(algo_params=tl), jps.xloci(algo_params=jl)) < TOL


# ---------------------------------------------------------------------------
# throughput, contrast curve and completeness of 4-d cubes
# ---------------------------------------------------------------------------

def _psf_cube(z, size=11, fwhm=4.0):
    yy, xx = np.mgrid[:size, :size]
    c = size // 2
    return np.stack([np.exp(-((yy - c) ** 2 + (xx - c) ** 2)
                            / (2 * ((fwhm + 0.2 * ch) / 2.355) ** 2))
                     for ch in range(z)])


@pytest.fixture(scope="module")
def cc_data():
    cube, angles, scal = _ifs(z=3, n=10, size=48, seed=4, span=0.2)
    return cube, angles, scal, _psf_cube(3)


CC = dict(ncomp=2, adimsdi="single", fc_rad_sep=3)


def test_throughput_4d(cc_data):
    cube, angles, scal, psf = cc_data
    ref = jm.throughput(cube, angles, psf, 4.0, jps.pca, nbranch=2,
                        full_output=True, scale_list=scal, verbose=False,
                        **CC)
    got = tm.throughput(cube, angles, psf, 4.0, tps.pca, nbranch=2,
                        full_output=True, scale_list=scal, verbose=False,
                        **CC)
    assert got[6].shape == ref[6].shape == (6, 3, 48, 48)
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


def test_contrast_curve_4d(cc_data):
    cube, angles, scal, psf = cc_data
    kw = dict(plot=False, verbose=False, nbranch=1, scale_list=scal, **CC)
    theirs = jm.contrast_curve(cube, angles, psf, 4.0, 0.0125, 1e4, jps.pca,
                               **kw)
    ours = _contrast_curve(cube, angles, psf, 4.0, 0.0125, 1e4, tps.pca,
                           **kw)[0]
    assert list(ours) == list(theirs.columns)
    for col in ours:
        ref = np.asarray(theirs[col], float)
        assert np.abs(ours[col] - ref).max() <= 1e-6 * np.abs(ref).max()


def test_contrast_curve_4d_checks(cc_data):
    cube, angles, scal, psf = cc_data
    with pytest.raises(TypeError, match="cube"):
        tm.contrast_curve(cube, angles, psf[0], 4.0, 0.0125, 1e4, tps.pca,
                          plot=False, verbose=False, scale_list=scal)
    with pytest.raises(NotImplementedError, match="slice 11"):
        tm.throughput(cube, angles, psf, 4.0, tps.pca, pattern_mesh=object(),
                      verbose=False, scale_list=scal)


def test_completeness_curve_4d(cc_data):
    """``completeness_curve`` takes a 4-d cube end to end: the injected
    4-d cubes go through the 4-d ``pca`` (vip_tpu's route)."""
    cube, angles, scal, psf = cc_data
    kw = dict(an_dist=[12], ini_contrast=[5e-3], starphot=1e4, pxscale=0.0125,
              n_fc=4, completeness=0.5, plot=False,
              algo_dict=dict(ncomp=2, scale_list=scal, adimsdi="single"))
    ref = jm.completeness_curve(cube, angles, psf, 4.0, jps.pca, **kw)
    got = tm.completeness_curve(cube, angles, psf, 4.0, tps.pca, **kw)
    for g, r in zip(got[:2], ref[:2]):
        assert np.allclose(_np(g), _np(r), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# PACO with a rescaling factor
# ---------------------------------------------------------------------------

def _paco_data():
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
    return cube, angs, psf[sz // 2 - 4:sz // 2 + 5,
                           sz // 2 - 4:sz // 2 + 5].copy()


@pytest.mark.parametrize("cls", ["FastPACO", "FullPACO"])
def test_paco_rescaling(cls):
    cube, angs, psf = _paco_data()
    ours = getattr(tp, cls)(cube=cube.copy(), angles=angs, psf=psf,
                            fwhm=2.0, pixscale=1.0, rescaling_factor=2.0,
                            verbose=False)
    snr, flux = ours.run()
    # the port keeps the resampled cube, vip_tpu's cube_px_resampling
    assert _err(ours.cube, jresample(cube, 2.0, verbose=False)) < TOL
    assert ours.fwhm == 4 and ours.pixscale == 0.5
    rescaled = jresample(cube, 2.0, verbose=False)
    theirs = getattr(jp, cls)(cube=rescaled, angles=angs,
                              psf=jresample_fr(psf, 2.0), fwhm=2.0,
                              pixscale=0.5, rescaling_factor=1.0,
                              verbose=False)
    assert theirs.patch_area_pixels == ours.patch_area_pixels
    assert theirs.patch_width == ours.patch_width
    snr_r, flux_r = theirs.run()
    snr_r, flux_r = np.asarray(snr_r), np.asarray(flux_r)
    for g, r in ((snr, snr_r), (flux, flux_r)):
        g = _np(g)
        fin = np.isfinite(r)
        assert np.array_equal(np.isfinite(g), fin)
        assert np.abs(g[fin] - r[fin]).max() <= TOL * np.abs(r[fin]).max()


# ---------------------------------------------------------------------------
# NEGFC on 4-d cubes
# ---------------------------------------------------------------------------

R, THETA, FWHM = 12.0, 35.0, 4.0
FLUXES = np.array([15.0, 11.0])


def _negfc4(n=10, size=45, seed=7):
    """Two channels of smooth noise with a companion (R, THETA) of a flux a
    channel, injected by vip_tpu with each channel's normalized PSF."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 50, n)
    yy, xx = np.mgrid[:15, :15]
    psfn = np.stack([jfm.normalize_psf(np.exp(
        -((yy - 7) ** 2 + (xx - 7) ** 2) / (2 * (f / 2.355) ** 2)), fwhm=f,
        verbose=False) for f in (FWHM, FWHM + 0.4)])
    cube = gaussian_filter(rng.standard_normal((2, n, size, size)),
                           (0, 0, 1.2, 1.2)) * 0.3
    cube = jfm.cube_inject_companions(cube, psfn, angles, flevel=FLUXES,
                                      rad_dists=[R], theta=THETA)
    cube_ref = gaussian_filter(rng.standard_normal((2, n, size, size)),
                               (0, 0, 1.2, 1.2)) * 0.3
    return cube, angles, psfn, cube_ref


@pytest.fixture(scope="module")
def negfc4():
    return _negfc4()


BOUNDS4 = [(R - 3, R + 3), (THETA - 10, THETA + 10), (0, 60), (0, 60)]
WALKERS = np.array([[R, THETA, 15.0, 11.0], [R + 0.4, THETA - 1.5, 13.0, 9.5],
                    [R - 0.7, THETA + 2.0, 18.0, 12.5],
                    [R, THETA, 70.0, 1.0]])


@pytest.mark.parametrize("kw", [
    dict(collapse_ifs="absmean"),
    dict(collapse_ifs="mean", collapse="mean"),
    dict(collapse_ifs="median", sigma="spe"),
    dict(collapse_ifs="sum", mu_sigma_is_tuple=False, fmerit="stddev"),
    dict(collapse_ifs="mean", cube_ref="4d", scaling="temp-mean"),
    dict(collapse_ifs="mean", transmission=np.array(
        [[0.0, 6.0, 30.0], [0.2, 0.7, 1.0], [0.3, 0.8, 1.0]])),
    dict(collapse_ifs="mean", weights=np.linspace(0.8, 1.2, 10)),
], ids=["absmean", "mean", "median-spe", "sum-stddev", "cube_ref",
        "transmission", "weights"])
def test_batched_lnprob_4d(negfc4, kw):
    cube, angles, psfn, cube_ref = negfc4
    kw = dict(kw)
    if kw.get("cube_ref") == "4d":
        kw["cube_ref"] = cube_ref
    args = (cube, angles, psfn, 3, 4, R, THETA, 1.0, FWHM, 0.001, 0.05 ** 2,
            BOUNDS4)
    ref = np.asarray(jmodel.make_batched_lnprob(*args, **kw)(
        jnp.asarray(WALKERS)))
    got = _np(tmodel.make_batched_lnprob(*args, **kw)(WALKERS))
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert np.max(np.abs(got[fin] - ref[fin]) / np.abs(ref[fin])) <= TOL


def test_batched_lnprob_4d_one_flux(negfc4):
    """(r, theta, f): one flux shared by the channels."""
    cube, angles, psfn, _ = negfc4
    args = (cube, angles, psfn, 3, 4, R, THETA, 1.0, FWHM, 0.001, 0.05 ** 2,
            BOUNDS4[:3])
    walkers = WALKERS[:3, :3]
    ref = np.asarray(jmodel.make_batched_lnprob(*args)(jnp.asarray(walkers)))
    got = _np(tmodel.make_batched_lnprob(*args)(walkers))
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= TOL


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mu_sigma=None, fmerit="stddev"),
    dict(weights=np.linspace(0.8, 1.2, 10), bin_spec=True),
    dict(bin_spec=True),
    dict(transmission=np.array([[0.0, 6.0, 30.0], [0.2, 0.7, 1.0],
                                [0.3, 0.8, 1.0]])),
], ids=["mu_sigma", "stddev", "weights", "bin_spec", "transmission"])
def test_chisquare_4d(negfc4, kw):
    cube, angles, psfn, _ = negfc4
    p = (R + 0.3, THETA - 1.0, 16.0) if kw.get("bin_spec") \
        else (R + 0.3, THETA - 1.0, 16.0, 10.0)
    kw.setdefault("mu_sigma", (0.001, 0.05))
    ref = jfm.chisquare(p, cube, angles, psfn, FWHM, 4, 1, (R, THETA), 3,
                        **kw)
    got = tfm.chisquare(p, cube, angles, psfn, FWHM, 4, 1, (R, THETA), 3,
                        **kw)
    assert abs(got - ref) <= TOL * abs(ref)


def test_lnlike_host_4d(negfc4):
    """The walker-by-walker host likelihood (``negfc_mcmc.lnlike``)."""
    cube, angles, psfn, _ = negfc4
    from vip_tpu.fm.negfc_mcmc import lnlike as jlnlike
    from vip_tpu_torch.fm.negfc_mcmc import lnlike as tlnlike

    for p in WALKERS[:3]:
        args = (tuple(p), cube, angles, psfn, FWHM, 4, 3, 1, (R, THETA))
        ref = jlnlike(*args, mu_sigma=(0.001, 0.05))
        got = tlnlike(*args, mu_sigma=(0.001, 0.05))
        assert abs(got - ref) <= TOL * abs(ref)


def test_firstguess_4d(negfc4):
    cube, angles, psfn, _ = negfc4
    cy, cx = cube.shape[-2] // 2, cube.shape[-1] // 2
    xy = (cx + R * np.cos(np.deg2rad(THETA)),
          cy + R * np.sin(np.deg2rad(THETA)))
    kw = dict(ncomp=3, fwhm=FWHM, annulus_width=4, aperture_radius=1,
              f_range=np.linspace(5, 25, 9), mu_sigma=(0.001, 0.05),
              simplex_options={"xatol": 1e-4, "fatol": 1e-4, "maxiter": 40,
                               "maxfev": 60}, verbose=False)
    ref = jfm.firstguess(cube, angles, psfn, xy, **kw)
    got = tfm.firstguess(cube, angles, psfn, xy, **kw)
    assert got[2].shape == ref[2].shape == (1, 2)
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 1e-6 * max(np.abs(r).max(), 1.0)
    # the grid alone, channel by channel
    ref = jfm.firstguess(cube, angles, psfn, xy, simplex=False, **kw)
    got = tfm.firstguess(cube, angles, psfn, xy, simplex=False, **kw)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


def test_get_mu_and_sigma_4d(negfc4):
    cube, angles, psfn, _ = negfc4
    args = (cube, angles, 3, 4, 1, FWHM, R, THETA)
    ref = jfm.get_mu_and_sigma(*args)
    got = tfm.get_mu_and_sigma(*args)
    assert np.allclose(got, ref, rtol=TOL, atol=0)


def test_get_mu_and_sigma_multi_flux_theta(negfc4):
    """With the companion's fluxes given, vip_tpu removes it at theta =
    r_guess (its fault, negfc_fmerit.py:275) and the port at theta_guess:
    equal when the two coincide, and only the port's removal empties the
    companion's aperture otherwise."""
    cube, angles, psfn, _ = negfc4
    kw = dict(f_guess=FLUXES, psfn=psfn)
    # theta_guess == r_guess: both remove a companion at the same place
    args = (cube, angles, 3, 4, 1, FWHM, R, R)
    assert np.allclose(tfm.get_mu_and_sigma(*args, **kw),
                       jfm.get_mu_and_sigma(*args, **kw), rtol=TOL, atol=0)
    # theta_guess = THETA: the port removes the companion, vip_tpu does not
    args = (cube, angles, 3, 4, 1, FWHM, R, THETA)
    ours = tfm.get_mu_and_sigma(*args, **kw)
    theirs = jfm.get_mu_and_sigma(*args, **kw)
    assert not np.allclose(ours, theirs, rtol=1e-3)
    clean = tfm.cube_planet_free(np.array([[R, R], [THETA, THETA], FLUXES]),
                                 cube, angles, psfn)
    assert np.allclose(ours, tfm.get_mu_and_sigma(clean, angles, 3, 4, 1,
                                                  FWHM, R, THETA, f_guess=[
                                                      0.0, 0.0], psfn=psfn),
                       rtol=1e-10, atol=0)
    assert ours[1] < theirs[1]


def test_speckle_noise_4d_refits(negfc4):
    """``speckle_noise_uncertainty``'s refit at one azimuth of a 4-d cube
    (r, theta, f_1, f_2), on the planet-free cube of each package: the
    port's and vip_tpu's agree. (A handful of azimuths is too few for its
    histogram of offsets, and enough for the tests' time.)"""
    from vip_tpu.fm.negfc_speckle_noise import \
        _estimate_speckle_one_angle as jone
    from vip_tpu_torch.fm.negfc_speckle_noise import \
        _estimate_speckle_one_angle as tone

    cube, angles, psfn, _ = negfc4
    pp = np.array([[[R, R], [THETA, THETA], FLUXES]])
    cube_pf = jfm.cube_planet_free(pp, cube, angles, psfn)
    assert _err(tfm.cube_planet_free(pp, cube, angles, psfn), cube_pf) < TOL
    opts = {"xatol": 1e-3, "fatol": 1e-3, "maxiter": 15, "maxfev": 20}
    for ang in (100.0, 220.0):
        args = (ang, cube_pf, psfn, angles, R, FLUXES, FWHM, 1, None, "sum",
                None, {"ncomp": 3}, None, False, (0.001, 0.05), None, False,
                None, opts, "vip-fft", "lanczos4")
        ref = jone(*args[:10], jps.pca_annulus, *args[11:], verbose=False)
        got = tone(*args[:10], tps.pca_annulus, *args[11:], verbose=False)
        assert len(got) == len(ref) == 11
        assert np.abs(np.subtract(got, ref)).max() <= 1e-6 * np.abs(
            ref).max()

"""The NEGFC slice as a whole in the port against vip_tpu, on the CPU at
float64: the first guess, the host likelihood, the MCMC, nested sampling
and the speckle-noise uncertainty.

- ``firstguess_from_coord``'s χ² curve: 1e-10 relative; ``firstguess``'s
  (r, theta, f) after the simplex: 1e-6 relative (Nelder-Mead's path
  follows χ² values equal to ~1e-15, and its stopping tolerances are
  looser than that).
- ``lnlike`` / ``lnprob`` on the host path: 1e-10 relative.
- ``mcmc_negfc_sampling`` with vip_tpu's threefry draws replayed through
  ``draws=`` (8 walkers, ``conv_test`` 'gb' and 'ac'; and the walker-by-
  walker host route on two threads): the chain within 1e-8 (measured
  bit-equal: a flipped acceptance would fork it by far more).
- ``nested_negfc_sampling`` from one numpy ``RandomState``: the same
  samples (1e-8) and evidence.
- ``speckle_noise_uncertainty`` at three azimuths: 1e-8 of max(|ref|, 1).
- ``confidence`` (no figure in the port unless asked): the same values.
"""

import numpy as np
import pytest
import threadpoolctl

import vip_tpu_torch
import vip_tpu.fm as jfm
import vip_tpu.psfsub as jps
import vip_tpu_torch.fm as tfm
import vip_tpu_torch.psfsub as tps
from test_torch_negfc_model import (FLUX, FWHM, R, THETA, jax_draws,
                                    negfc_data)

TOL = 1e-10
CHAIN_TOL = 1e-8


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
def data():
    return negfc_data(n=8, size=41)


def _planet_xy(cube):
    c = cube.shape[-1] // 2
    return (c + R * np.cos(np.deg2rad(THETA)),
            c + R * np.sin(np.deg2rad(THETA)))


def test_firstguess_from_coord_curve(data):
    cube, angles, psfn, _ = data
    c = cube.shape[-1] // 2
    kw = dict(ncomp=3, f_range=np.geomspace(2, 60, 10), verbose=False,
              full_output=True, mu_sigma=(0.0, 0.05))
    ref = jfm.firstguess_from_coord(_planet_xy(cube), (c, c), cube, angles,
                                    psfn, FWHM, 4, 1, **kw)
    got = tfm.firstguess_from_coord(_planet_xy(cube), (c, c), cube, angles,
                                    psfn, FWHM, 4, 1, **kw)
    assert len(got[2]) == len(ref[2]) >= 5
    assert np.max(np.abs(got[2] - ref[2]) / np.abs(ref[2])) <= TOL
    assert np.allclose(got[0], ref[0], rtol=TOL, atol=0)


def test_firstguess(data):
    cube, angles, psfn, _ = data
    kw = dict(ncomp=3, fwhm=FWHM, annulus_width=4, aperture_radius=1,
              f_range=np.geomspace(1, 100, 8), verbose=False,
              simplex_options=dict(xatol=1e-4, fatol=1e-4, maxiter=60))
    ref = jfm.firstguess(cube, angles, psfn, [_planet_xy(cube)], **kw)
    got = tfm.firstguess(cube, angles, psfn, [_planet_xy(cube)], **kw)
    for g, r in zip(got, ref):
        assert np.allclose(g, r, rtol=1e-6, atol=0)
    assert abs(got[0][0] - R) < 0.5 and abs(got[2][0] - FLUX) < 0.2 * FLUX


@pytest.mark.parametrize("mu_sigma,fmerit", [((0.001, 0.05), "sum"),
                                             (0.001, "sum"),
                                             (0.001, "stddev")])
def test_host_lnlike_and_lnprob(data, mu_sigma, fmerit):
    cube, angles, psfn, _ = data
    bounds = [(R - 2, R + 2), (THETA - 10, THETA + 10), (0, 5 * FLUX)]
    for p in [(R, THETA, FLUX), (R + 0.5, THETA - 2.0, FLUX * 1.2)]:
        kw = dict(mu_sigma=mu_sigma, fmerit=fmerit)
        ref = jfm.lnprob(p, bounds, cube, angles, psfn, FWHM, 4, 3, 1.0,
                         (R, THETA, FLUX), **kw)
        got = tfm.lnprob(p, bounds, cube, angles, psfn, FWHM, 4, 3, 1.0,
                         (R, THETA, FLUX), **kw)
        assert abs(got - ref) <= TOL * abs(ref)
        ref = jfm.lnlike(p, cube, angles, psfn, FWHM, 4, 3, 1.0,
                         (R, THETA, FLUX), sigma="pho", **kw)
        got = tfm.lnlike(p, cube, angles, psfn, FWHM, 4, 3, 1.0,
                         (R, THETA, FLUX), sigma="pho", **kw)
        assert abs(got - ref) <= TOL * abs(ref)
    assert tfm.lnprob((R + 3, THETA, FLUX), bounds, cube, angles, psfn,
                      FWHM, 4, 3, 1.0, (R, THETA, FLUX)) == -np.inf


MCMC = dict(ncomp=3, annulus_width=4, aperture_radius=1, fwhm=FWHM,
            nwalkers=8, niteration_min=3, rng_seed=3)


@pytest.mark.parametrize("case", ["gb", "ac", "host"])
def test_mcmc_replays_vip_tpu(data, case):
    cube, angles, psfn, _ = data
    kw = dict(MCMC, conv_test="ac" if case == "host" else case,
              niteration_limit=4 if case == "host" else 6)
    if case == "host":
        # a radial-gradient transmission takes the walker-by-walker host
        # likelihood in both packages, here on two threads
        kw.update(transmission=np.array([[0.0, 6.0, 30.0],
                                         [0.3, 0.8, 1.0]]),
                  radial_gradient=True, nproc=2)
    ref = jfm.mcmc_negfc_sampling(cube, angles, psfn, (R, THETA, FLUX), **kw)
    got = tfm.mcmc_negfc_sampling(
        cube, angles, psfn, (R, THETA, FLUX),
        draws=jax_draws(3, 8, kw["niteration_limit"]), **kw)
    assert got.shape == ref.shape and ref.shape[1] >= 4
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= CHAIN_TOL
    # walkers moved: some proposals were accepted
    assert np.any(got[:, -1] != got[:, 0])


def test_mcmc_theta_zero_and_not_ported(data):
    cube, angles, psfn, _ = data
    # theta 0 turns into 360 for the initial ball and the bounds
    kw = dict(MCMC, niteration_limit=2, conv_test="gb")
    got = tfm.mcmc_negfc_sampling(cube, angles, psfn, (R, 0.0, FLUX),
                                  draws=jax_draws(3, 8, 2), **kw)
    ref = jfm.mcmc_negfc_sampling(cube, angles, psfn, (R, 0.0, FLUX), **kw)
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= CHAIN_TOL
    assert np.all(np.abs(got[:, :, 1] - 360) < 20)
    with pytest.raises(NotImplementedError, match="slice 11"):
        tfm.mcmc_negfc_sampling(cube, angles, psfn, (R, THETA, FLUX),
                                walker_mesh=object(), **kw)


def test_nested_sampling_same_samples(data):
    cube, angles, psfn, _ = data
    kw = dict(ncomp=3, annulus_width=4, npoints=15, dlogz=2.0, w=(1, 2, 5),
              verbose=False)
    ref = jfm.nested_negfc_sampling((R, THETA, FLUX), cube, angles, psfn,
                                    FWHM, rstate=np.random.RandomState(5),
                                    **kw)
    got = tfm.nested_negfc_sampling((R, THETA, FLUX), cube, angles, psfn,
                                    FWHM, rstate=np.random.RandomState(5),
                                    **kw)
    assert got.samples.shape == ref.samples.shape
    assert ref.samples.shape[0] > kw["npoints"]
    assert np.max(np.abs(got.samples - ref.samples)) <= CHAIN_TOL
    assert abs(got.logz - ref.logz) <= CHAIN_TOL * max(abs(ref.logz), 1)
    assert got.niter == ref.niter
    np.testing.assert_allclose(
        tfm.nested_sampling_results(got, verbose=False),
        jfm.nested_sampling_results(ref, verbose=False), rtol=CHAIN_TOL)


def test_speckle_noise_uncertainty(data):
    cube, angles, psfn, _ = data
    kw = dict(algo_options=dict(ncomp=3), verbose=False, full_output=True,
              simplex_options=dict(xatol=1e-3, fatol=1e-3, maxiter=30),
              mu_sigma=None)
    ref = jfm.speckle_noise_uncertainty(
        cube, (R, THETA, FLUX), np.array([0, 120, 240, 360]), angles,
        jps.pca_annulus, psfn, FWHM, 1, **kw)
    got = tfm.speckle_noise_uncertainty(
        cube, (R, THETA, FLUX), np.array([0, 120, 240, 360]), angles,
        tps.pca_annulus, psfn, FWHM, 1, **kw)
    assert got[2].shape == (3, 3)
    for g, r in zip(got, ref):
        g, r = np.asarray(g, float), np.asarray(r, float)
        assert np.max(np.abs(g - r)) <= CHAIN_TOL * max(np.max(np.abs(r)), 1)


@pytest.mark.parametrize("gaussian_fit", [False, True])
def test_confidence(gaussian_fit):
    import matplotlib.pyplot as plt

    samples = np.random.default_rng(6).normal([12, 35, 15], [0.2, 1, 2],
                                              (2000, 3))
    ref = jfm.confidence(samples, bins=40, gaussian_fit=gaussian_fit,
                         verbose=False)
    plt.close("all")
    got = tfm.confidence(samples, bins=40, gaussian_fit=gaussian_fit,
                         verbose=False)
    assert not plt.get_fignums()    # the port draws only when asked
    if gaussian_fit:
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    else:
        for lab in ("r", "theta", "f"):
            assert got[0][lab] == ref[0][lab]
            np.testing.assert_array_equal(got[1][lab], ref[1][lab])

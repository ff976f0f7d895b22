"""The port's batched NEGFC likelihood (``ops.negfc_model``) against
vip_tpu's vmapped one, on the CPU at float64.

Every 3-d branch of vip_tpu's device model: per-frame ``weights``, a
``transmission`` table (one that covers the companion and one that stops
short, which the injector pads with 1 at the frame's diagonal), a
``cube_ref`` library, the four ``scaling`` modes, ``force_rPA``, the
collapses 'median', 'mean' and 'sum', the (mu, sigma) merit with sigma
'spe', 'pho' and 'spe+pho', the 'sum' and 'stddev' merits, and walkers
outside the bounds (-inf). Tolerance: 1e-8 relative to each walker's
log-probability (measured ~1e-15: the same float64 FFTs, SVD and median
in another library). For a fractional r_guess, where vip_tpu's model
keeps other aperture pixels than its host lnprob (ROADMAP.md Queue 3),
the port is held to the host lnprob. ``run_stretch_mcmc`` with
vip_tpu's threefry draws replayed through ``key`` returns vip_tpu's chain
and log-probabilities within 1e-8. The data of the NEGFC tests (``negfc_data``,
``jax_draws``) live here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch
from scipy.ndimage import gaussian_filter

import vip_tpu_torch
import vip_tpu.fm as jfm
from vip_tpu.ops import negfc_model as jmodel
from vip_tpu_torch.ops import negfc_model as tmodel

TOL = 1e-8
R, THETA, FLUX, FWHM = 12.0, 35.0, 15.0, 4.0


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


def negfc_data(n=10, size=45, seed=7):
    """A smooth-noise cube with a companion (R, THETA, FLUX) injected by
    vip_tpu, its angles, vip_tpu's normalized 15² Gaussian PSF of FWHM 4
    and a reference cube of other noise."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 50, n)
    yy, xx = np.mgrid[:15, :15]
    psf = np.exp(-((yy - 7) ** 2 + (xx - 7) ** 2)
                 / (2 * (FWHM / 2.355) ** 2))
    psfn = jfm.normalize_psf(psf, fwhm=FWHM, verbose=False)
    cube = gaussian_filter(rng.standard_normal((n, size, size)), 1.2) * 0.3
    cube = jfm.cube_inject_companions(cube, psfn, angles, flevel=FLUX,
                                      rad_dists=[R], theta=THETA)
    cube_ref = gaussian_filter(rng.standard_normal((n, size, size)),
                               1.2) * 0.3
    return cube, angles, psfn, cube_ref


def jax_draws(seed, nwalkers, nsteps):
    """vip_tpu's stretch-move draws (fm/negfc_mcmc.py:348-382: the key
    split in four each half-update) as the port's ``draws`` callable."""
    key = jax.random.PRNGKey(seed)
    half = nwalkers // 2
    table = []
    for _ in range(nsteps):
        for ns0, n1 in ((half, nwalkers - half), (nwalkers - half, half)):
            key, kz, kc, ku = jax.random.split(key, 4)
            table.append((np.asarray(jax.random.uniform(kz, (ns0,))),
                          np.asarray(jax.random.randint(kc, (ns0,), 0, n1)),
                          np.asarray(jax.random.uniform(ku, (ns0,)))))

    def draws(step, half_index, ns0, n1):
        u_z, partners, u_acc = table[2 * step + half_index]
        assert len(u_z) == ns0
        return u_z, partners, u_acc
    return draws


@pytest.fixture(scope="module")
def data():
    return negfc_data()


BOUNDS = [(R - 2, R + 2), (THETA - 10, THETA + 10), (0, 5 * FLUX)]
# walkers: the truth, two nearby, one outside r's bounds, one outside f's
PARAMS = np.array([[R, THETA, FLUX], [R + 0.5, THETA - 2.0, FLUX * 1.2],
                   [R - 0.7, THETA + 3.0, FLUX * 0.8],
                   [R + 2.5, THETA, FLUX], [R, THETA, -1.0]])
TRANS = np.array([[0.0, 4.0, 8.0, 14.0, 30.0], [0.0, 0.3, 0.7, 1.0, 1.0]])
TRANS_SHORT = np.array([[1.0, 4.0, 8.0], [0.1, 0.3, 0.6]])

BRANCHES = {
    "default": {},
    "weights": dict(weights=np.linspace(0.8, 1.2, 10)),
    "transmission": dict(transmission=TRANS),
    "transmission-short": dict(transmission=TRANS_SHORT),
    "cube_ref": dict(cube_ref="ref"),
    "temp-mean": dict(scaling="temp-mean"),
    "spat-mean": dict(scaling="spat-mean"),
    "temp-standard": dict(scaling="temp-standard"),
    "spat-standard": dict(scaling="spat-standard"),
    "collapse-mean": dict(collapse="mean"),
    "collapse-sum": dict(collapse="sum"),
    "sigma-spe": dict(sigma="spe"),
    "sigma-pho": dict(sigma="pho"),
    "fmerit-sum": dict(mu_sigma_is_tuple=False, fmerit="sum"),
    "fmerit-stddev": dict(mu_sigma_is_tuple=False, fmerit="stddev"),
    "eigen": dict(svd_method="eigen"),
}


def _both(data, branch, params, ncomp=3, bounds=BOUNDS, **extra):
    cube, angles, psfn, cube_ref = data
    kw = dict(BRANCHES[branch], **extra)
    if kw.get("cube_ref") == "ref":
        kw["cube_ref"] = cube_ref
    sig2 = 0.0 if kw.get("mu_sigma_is_tuple", True) is False else 0.05 ** 2
    args = (cube, angles, psfn, ncomp, 4, R, THETA, 1.0, FWHM, 0.001, sig2,
            bounds)
    ref = np.asarray(jmodel.make_batched_lnprob(*args, **kw)(
        jnp.asarray(params)))
    got = tmodel.make_batched_lnprob(*args, **kw)(params)
    return got.numpy(), ref


def _check(got, ref):
    fin = np.isfinite(ref)
    assert fin.sum() >= 3
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert np.all(got[~fin] == -np.inf)
    assert np.max(np.abs(got[fin] - ref[fin]) / np.abs(ref[fin])) <= TOL


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_batched_lnprob_branches(data, branch):
    _check(*_both(data, branch, PARAMS))


def test_batched_lnprob_force_rpa(data):
    bounds = [(0, 5 * FLUX)]
    params = np.array([[FLUX], [FLUX * 1.3], [FLUX * 0.6], [-2.0]])
    _check(*_both(data, "default", params, bounds=bounds, force_rPA=True))


def test_walkers_in_passes(data, monkeypatch):
    """A working set of one walker a pass gives the batch's values."""
    cube, angles, psfn, _ = data
    args = (cube, angles, psfn, 3, 4, R, THETA, 1.0, FWHM, 0.001, 0.05 ** 2,
            BOUNDS)
    whole = tmodel.make_batched_lnprob(*args)(PARAMS).numpy()
    monkeypatch.setattr(tmodel, "_WORKING_SET", 1)
    passes = tmodel.make_batched_lnprob(*args)(PARAMS).numpy()
    np.testing.assert_array_equal(passes, whole)


def test_single_walker_lnprob(data):
    cube, angles, psfn, _ = data
    args = (cube, angles, psfn, 3, 4, R, THETA, 1.0, FWHM, 0.001, 0.05 ** 2,
            BOUNDS)
    ref = float(jmodel.make_negfc_lnprob(*args)(jnp.asarray(PARAMS[1])))
    got = tmodel.make_negfc_lnprob(*args)(PARAMS[1])
    assert got.dim() == 0
    assert abs(float(got) - ref) <= TOL * abs(ref)


def test_fractional_r_guess_follows_the_host_lnprob(data):
    """For a fractional r_guess the aperture is cut by the annulus
    r_guess -+ annulus_width / 2, as get_values_optimize (and so vip_tpu's
    host lnprob) cuts it; vip_tpu's model cuts it by pca_annulus's annulus
    of integer radii instead (ROADMAP.md Queue 3), so the port is held to
    vip_tpu's host lnprob here."""
    cube, angles, psfn, _ = data
    r_guess, theta_guess = R + 0.6, THETA - 0.7
    bounds = [(r_guess - 2, r_guess + 2), (theta_guess - 10,
                                           theta_guess + 10), (0, 5 * FLUX)]
    got = tmodel.make_batched_lnprob(
        cube, angles, psfn, 3, 4, r_guess, theta_guess, 1.0, FWHM, 0.001,
        0.05 ** 2, bounds)(PARAMS[:3]).numpy()
    ref = np.array([jfm.lnprob(tuple(p), bounds, cube, angles, psfn, FWHM, 4,
                               3, 1.0, (r_guess, theta_guess),
                               mu_sigma=(0.001, 0.05)) for p in PARAMS[:3]])
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= TOL
    theirs = np.asarray(jmodel.make_batched_lnprob(
        cube, angles, psfn, 3, 4, r_guess, theta_guess, 1.0, FWHM, 0.001,
        0.05 ** 2, bounds)(jnp.asarray(PARAMS[:3])))
    assert np.max(np.abs(theirs - ref) / np.abs(ref)) > 1e-3


def test_batched_lnprob_4d_raises(data):
    """Slice 7 ported the 4-d cube: two channels, one flux shared, against
    vip_tpu (tests/test_torch_ifs_more.py holds the other branches)."""
    cube, angles, psfn, _ = data
    args = (np.stack([cube, 0.9 * cube]), angles, np.stack([psfn, psfn]), 3,
            4, R, THETA, 1.0, FWHM, 0.001, 0.05 ** 2, BOUNDS)
    ref = np.asarray(jmodel.make_batched_lnprob(*args)(
        jnp.asarray(PARAMS[:3])))
    got = tmodel.make_batched_lnprob(*args)(PARAMS[:3]).numpy()
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= TOL


def test_run_stretch_mcmc_replays_vip_tpu(data):
    cube, angles, psfn, _ = data
    args = (cube, angles, psfn, 3, 4, R, THETA, 1.0, FWHM, 0.001, 0.05 ** 2,
            BOUNDS)
    rng = np.random.default_rng(0)
    pos0 = np.array([R, THETA, FLUX]) * (1 + rng.normal(0, 0.01, (6, 3)))
    ref = jmodel.run_stretch_mcmc(jmodel.make_batched_lnprob(*args), pos0, 4,
                                  jax.random.PRNGKey(5))
    got = tmodel.run_stretch_mcmc(tmodel.make_batched_lnprob(*args), pos0, 4,
                                  jax_draws(5, 6, 4))
    assert np.max(np.abs(got[0] - ref[0]) / np.abs(ref[0])) <= TOL
    assert np.max(np.abs(got[1] - ref[1]) / np.abs(ref[1])) <= TOL
    assert got[2] == ref[2] and got[2] > 0
    # the torch.Generator route draws its own moves, and repeats itself
    a = tmodel.run_stretch_mcmc(tmodel.make_batched_lnprob(*args), pos0, 2,
                                torch.Generator().manual_seed(1))
    b = tmodel.run_stretch_mcmc(tmodel.make_batched_lnprob(*args), pos0, 2,
                                torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a[0], b[0])

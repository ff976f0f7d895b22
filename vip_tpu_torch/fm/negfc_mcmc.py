"""NEGFC MCMC of a companion's (r, theta, flux) (port of
``vip_tpu.fm.negfc_mcmc``).

The affine-invariant stretch move runs on the host; each half-ensemble's
proposals go to the device as one batch and their log-probabilities come
back as one read (``ops.negfc_model.make_batched_lnprob``: CUDA kernels
H2 and H1 on the card). The host keeps vip_tpu's convergence machinery:
the geometric schedule of checks, the Gelman-Rubin and autocorrelation
tests, and the chain's growth. Configurations that the batched model
does not cover (another algo, unknown ``algo_options``, a radial-gradient
transmission) evaluate ``lnprob`` walker by walker, on ``nproc`` threads.

Random draws: the initial ball is numpy's ``default_rng(rng_seed)``, as
vip_tpu's; the stretch moves come from the keyword-only ``draws``
callable (``ops.negfc_model``'s convention), or else from a
``torch.Generator`` seeded with ``rng_seed`` (vip_tpu draws them from
jax's threefry, which the port does not have). A 4-d cube samples (r,
theta, f_1, ..., f_z) with the batched model's channel loop.
``walker_mesh`` waits for ROADMAP Queue 1, slice 11; matplotlib is
imported only to draw.
"""

import datetime

import numpy as np
import torch

from ..config import sep as SEP, time_ini, timing
from ..config.device import as_tensor
from ..ops.negfc_model import _draws_of, _stretch_sweep, make_batched_lnprob
from ..psfsub.svd import MODE_TO_METHOD
from ..psfsub.utils_pca import pca_annulus
from .negfc_fmerit import (_check_cube, _inject_negative, _shift_imlibs,
                           get_mu_and_sigma, get_values_optimize)
from .fakecomp import _host
from .utils_mcmc import autocorr_test, gelman_rubin

__all__ = ["mcmc_negfc_sampling", "lnprior", "lnlike", "lnprob",
           "chain_zero_truncated", "show_walk_plot", "show_corner_plot",
           "confidence"]


def lnprior(param, bounds, force_rPA=False):
    """Flat prior: 0 inside ``bounds``, -inf outside (vip_tpu
    negfc_mcmc.py:35)."""
    for i in range(len(param)):
        if not bounds[i][0] <= param[i] <= bounds[i][1]:
            return -np.inf
    return 0.0


def lnlike(param, cube, angs, psf_norm, fwhm, annulus_width, ncomp,
           aperture_radius, initial_state, cube_ref=None, svd_mode="lapack",
           scaling=None, algo=pca_annulus, delta_rot=1, fmerit="sum",
           imlib="vip-fft", interpolation="lanczos4", collapse="median",
           algo_options={}, weights=None, transmission=None,
           radial_gradient=False, mu_sigma=True, sigma="spe+pho",
           force_rPA=False, debug=False):
    """Log-likelihood of one walker's ``param`` (vip_tpu
    negfc_mcmc.py:43; same parameters): the negative companion injected
    and the cube reduced on the cube's device, the aperture values'
    Gaussian (``mu_sigma`` a tuple) or 'sum'/'stddev' merit on the host.
    With ``debug`` also the injected cube (a tensor). A 4-d cube takes one
    flux a channel, or one for all."""
    _check_cube(cube)
    imlib_sh, imlib_rot = _shift_imlibs(imlib)
    if force_rPA:
        r0, theta0 = initial_state[0], initial_state[1]
        flux = np.array(param) if len(param) > 1 else param[0]
    else:
        r0, theta0 = param[0], param[1]
        flux = np.array(param[2:]) if len(param) > 3 else param[2]
    if weights is not None:
        flux = flux * np.asarray(weights) if np.isscalar(flux) \
            else np.outer(flux, weights)

    cube_negfc = _inject_negative(as_tensor(cube), psf_norm, _host(angs),
                                  r0, theta0, flux, imlib_sh, interpolation,
                                  transmission, radial_gradient)
    values = get_values_optimize(cube_negfc, angs, ncomp, annulus_width,
                                 aperture_radius, fwhm, initial_state[0],
                                 initial_state[1], cube_ref=cube_ref,
                                 svd_mode=svd_mode, scaling=scaling,
                                 algo=algo, delta_rot=delta_rot,
                                 imlib=imlib_rot,
                                 interpolation=interpolation,
                                 collapse=collapse,
                                 algo_options=algo_options, weights=None)

    if isinstance(mu_sigma, tuple):
        mu = mu_sigma[0]
        sigma2 = mu_sigma[1] ** 2
        num = np.power(mu - values, 2)
        denom = 0
        if "spe" in sigma:
            denom += sigma2
        if "pho" in sigma:
            denom += np.abs(values - mu)
        lnlikelihood = -0.5 * np.sum(num / denom)
    else:
        mu = mu_sigma
        if fmerit == "sum":
            lnlikelihood = -0.5 * np.sum(np.abs(values - mu))
        elif fmerit == "stddev":
            values = values[values != 0]
            lnlikelihood = -np.std(values, ddof=1) * values.size
        else:
            raise RuntimeError("fmerit choice not recognized.")
    if debug:
        return lnlikelihood, cube_negfc
    return lnlikelihood


def lnprob(param, bounds, cube, angs, psf_norm, fwhm, annulus_width, ncomp,
           aperture_radius, initial_state, cube_ref=None, svd_mode="lapack",
           scaling=None, algo=pca_annulus, delta_rot=1, fmerit="sum",
           imlib="vip-fft", interpolation="lanczos4", collapse="median",
           algo_options={}, weights=None, transmission=None,
           radial_gradient=False, mu_sigma=True, sigma="spe+pho",
           force_rPA=False, display=False):
    """``lnprior`` + ``lnlike`` of one walker (vip_tpu negfc_mcmc.py:120;
    same parameters); -inf outside the bounds without a reduction."""
    lp = lnprior(param, bounds, force_rPA)
    if np.isinf(lp):
        return -np.inf
    return lp + lnlike(param, cube, angs, psf_norm, fwhm, annulus_width,
                       ncomp, aperture_radius, initial_state, cube_ref,
                       svd_mode, scaling, algo, delta_rot, fmerit, imlib,
                       interpolation, collapse, algo_options, weights,
                       transmission, radial_gradient, mu_sigma, sigma,
                       force_rPA)


def mcmc_negfc_sampling(cube, angs, psfn, initial_state, algo=pca_annulus,
                        ncomp=1, annulus_width=8, aperture_radius=1, fwhm=4,
                        mu_sigma=True, sigma="spe+pho", force_rPA=False,
                        fmerit="sum", cube_ref=None, svd_mode="lapack",
                        scaling=None, delta_rot=1, imlib="vip-fft",
                        interpolation="lanczos4", collapse="median",
                        algo_options={}, wedge=None, weights=None,
                        transmission=None, radial_gradient=False,
                        nwalkers=100, bounds=None, a=2.0, burnin=0.3,
                        rhat_threshold=1.01, rhat_count_threshold=1,
                        niteration_min=10, niteration_limit=10000,
                        niteration_supp=0, check_maxgap=20, conv_test="ac",
                        ac_c=50, ac_count_thr=3, nproc=1,
                        output_dir="results/", output_file=None,
                        display=False, verbosity=0, save=False,
                        rng_seed=0, walker_mesh=None, *, draws=None):
    """Affine-invariant MCMC of (r, theta, f) with the NEGFC technique
    (vip_tpu negfc_mcmc.py:139; same parameters and defaults). Returns the
    chain (nwalkers, nsteps, ndim), zero-truncated.

    ``draws``: the stretch moves' draws, ``draws(step, half, ns0, n1) ->
    (u_z, partners, u_accept)`` (``ops.negfc_model``); None draws them
    from a ``torch.Generator`` seeded with ``rng_seed``. ``walker_mesh``
    (vip_tpu's sharding of the walkers over devices) raises until slice
    11. A 4-d cube takes a (channels, y, x) ``psfn`` and
    ``initial_state`` (r, theta, f_1, ..., f_z)."""
    _check_cube(cube)
    if walker_mesh is not None:
        raise NotImplementedError(
            "mcmc_negfc_sampling: walker_mesh is not ported yet (fm/sharded"
            ".py; ROADMAP.md, Queue 1, slice 11)")
    if verbosity > 0:
        start_time = time_ini()
        print("        MCMC sampler for the NEGFC technique       ")
        print(SEP)

    if imlib == "opencv":
        imlib_rot = imlib
    elif imlib in ("skimage", "ndimage-interp"):
        imlib_rot = "skimage"
    else:
        imlib_rot = "vip-fft"

    initial_state = np.array(initial_state, dtype=float)
    if initial_state[1] == 0:
        initial_state[1] = 360  # for appropriate scaling of initial ball
    dim = len(initial_state) - 2 if force_rPA else len(initial_state)

    norm_weights = None
    if weights is not None:
        norm_weights = weights / np.sum(weights)

    mu_sig = get_mu_and_sigma(
        cube, angs, ncomp, annulus_width, aperture_radius, fwhm,
        initial_state[0], initial_state[1], initial_state[2:], psfn,
        cube_ref=cube_ref, wedge=wedge, svd_mode=svd_mode, scaling=scaling,
        algo=algo, delta_rot=delta_rot, imlib=imlib_rot,
        interpolation=interpolation, collapse=collapse,
        weights=norm_weights, algo_options=algo_options)
    if isinstance(mu_sigma, tuple):
        if len(mu_sigma) != 2:
            raise TypeError("if a tuple, mu_sigma should have 2 elements")
    elif mu_sigma:
        mu_sigma = mu_sig
        if verbosity > 0:
            print("The mean and stddev in the annulus at the radius of the "
                  f"companion are {mu_sigma[0]:.2f} and {mu_sigma[1]:.2f} "
                  "respectively.")
    else:
        mu_sigma = mu_sig[0]

    limit = niteration_limit
    itermin = niteration_min
    supp = niteration_supp
    maxgap = check_maxgap
    if itermin > limit:
        itermin = 0

    if bounds is None:
        bounds = []
        d0 = 0
        if not force_rPA:
            dr = min(annulus_width / 2, aperture_radius * fwhm / 2)
            dth = 360.0 / (2 * np.pi * initial_state[0]
                           / (aperture_radius * fwhm / 2))
            bounds = [(initial_state[0] - dr, initial_state[0] + dr),
                      (initial_state[1] - dth, initial_state[1] + dth)]
            d0 = 2
        for i in range(dim - d0):
            bounds.append((0, 5 * initial_state[d0 + i]))

    # size of the ball of the initial positions
    init = initial_state[2:] if force_rPA else initial_state
    scal = abs(bounds[0][0] - init[0]) / init[0]
    for i in range(dim):
        for j in range(2):
            test_scal = abs(bounds[i][j] - init[i]) / init[i]
            if test_scal < scal:
                scal = test_scal
    rng = np.random.default_rng(rng_seed)
    pos = init * (1 + rng.normal(0, scal / 50.0, (nwalkers, dim)))

    # the batched likelihood on the device where it covers the
    # configuration (vip_tpu negfc_mcmc.py:254-271), else walker by walker
    dev_opts = dict(algo_options)
    opt = {k: dev_opts.pop(k, d) for k, d in (
        ("ncomp", ncomp), ("svd_mode", svd_mode), ("scaling", scaling),
        ("collapse", collapse), ("collapse_ifs", "absmean"), ("nproc", 1),
        ("verbose", False), ("imlib", imlib),
        ("interpolation", interpolation))}
    use_device = (
        algo is pca_annulus
        and not dev_opts  # unknown algo_options -> host path
        and opt["collapse"] in ("median", "mean", "sum")
        and opt["collapse_ifs"] in ("absmean", "mean", "median", "sum")
        and not radial_gradient
        and (isinstance(mu_sigma, tuple) or fmerit in ("sum", "stddev"))
        and opt["imlib"] in ("vip-fft", "ndimage-fourier")
        and np.ndim(psfn) == (2 if cube.ndim == 3 else 3)
    )
    walker_pool = None
    if use_device:
        if verbosity > 0:
            print("Evaluating all walkers on the device (batched "
                  "likelihood)...")
        if isinstance(mu_sigma, tuple):
            dev_mu, dev_sig2 = mu_sigma[0], mu_sigma[1] ** 2
        else:
            dev_mu, dev_sig2 = float(mu_sigma), 0.0
        lnprob_batched = make_batched_lnprob(
            cube, angs, psfn, opt["ncomp"], annulus_width, initial_state[0],
            initial_state[1], aperture_radius, fwhm, dev_mu, dev_sig2,
            bounds, svd_method=MODE_TO_METHOD.get(opt["svd_mode"], "lapack"),
            collapse=opt["collapse"], sigma=sigma, force_rPA=force_rPA,
            weights=weights, transmission=transmission, cube_ref=cube_ref,
            scaling=opt["scaling"], collapse_ifs=opt["collapse_ifs"],
            mu_sigma_is_tuple=isinstance(mu_sigma, tuple), fmerit=fmerit)
    else:
        def _lnprob_one(p):
            return lnprob(tuple(p), bounds, cube, angs, psfn, fwhm,
                          annulus_width, ncomp, aperture_radius,
                          initial_state, cube_ref, svd_mode, scaling, algo,
                          delta_rot, fmerit, imlib, interpolation, collapse,
                          algo_options, weights, transmission,
                          radial_gradient, mu_sigma, sigma, force_rPA)

        if nproc > 1:
            # the reference's fork pool (negfc_mcmc.py:950-963) as threads:
            # a forked worker cannot use the parent's CUDA context
            import concurrent.futures

            walker_pool = concurrent.futures.ThreadPoolExecutor(nproc)

            def lnprob_batched(coords):
                return np.fromiter(walker_pool.map(_lnprob_one, coords),
                                   dtype=float)
        else:
            def lnprob_batched(coords):
                return np.array([_lnprob_one(p) for p in coords])

    try:
        chain, lp, n_accepted, k = _sample(
            lnprob_batched, pos, _draws_of(
                draws if draws is not None
                else torch.Generator().manual_seed(rng_seed)),
            a, dim, limit + supp, itermin, maxgap, burnin, rhat_threshold,
            rhat_count_threshold, supp, conv_test, ac_c, ac_count_thr,
            force_rPA, display, verbosity)
    finally:
        if walker_pool is not None:
            walker_pool.shutdown(wait=False)

    if save:
        import os
        import pickle

        os.makedirs(output_dir, exist_ok=True)
        output = {"chain": chain_zero_truncated(chain),
                  "AR": n_accepted / (k + 1), "lnprobability": lp}
        if output_file is None:
            output_file = "MCMC_results"
        with open(output_dir + "/" + output_file, "wb") as f:
            pickle.dump(output, f)
        print(f"\nThe file MCMC_results has been stored in the folder "
              f"{output_dir}/")
    if verbosity > 0:
        timing(start_time)
    return chain_zero_truncated(chain)


def _sample(lnprob_batched, pos, draws, a, dim, nIterations, itermin, maxgap,
            burnin, rhat_threshold, rhat_count_threshold, supp, conv_test,
            ac_c, ac_count_thr, force_rPA, display, verbosity):
    """The stretch-move loop with the reference's convergence schedule
    (vip_tpu negfc_mcmc.py:346-463). Returns (chain, lnprobs, accepted
    counts, last step)."""
    nwalkers = pos.shape[0]
    coords = np.asarray(pos, dtype=float).copy()
    lp = lnprob_batched(coords)
    lp = np.array(lp.cpu() if isinstance(lp, torch.Tensor) else lp,
                  dtype=float)
    n_accepted = np.zeros(nwalkers)

    fraction = 0.3
    geom = 0
    lastcheck = 0
    konvergence = np.inf
    rhat_count = 0
    ac_count = 0
    chain = np.empty([nwalkers, 1, dim])
    rhat = np.zeros(dim)
    stop = np.inf

    start = datetime.datetime.now()
    k = -1
    for k in range(nIterations):
        n_accepted += _stretch_sweep(coords, lp, lnprob_batched, draws, k, a)
        if verbosity > 1 and k % 50 == 0:
            elapsed = (datetime.datetime.now() - start).total_seconds()
            print(f"{k}\t\t{elapsed / (k + 1):.5f} s/step", flush=True)

        # dynamic chain growth (negfc_mcmc.py:994-1000)
        s = chain.shape[1]
        if k + 1 > s:
            chain = np.concatenate((chain, np.zeros([nwalkers, 2 * s, dim])),
                                   axis=1)
        chain[:, k] = coords

        # convergence checks on the geometric schedule
        criterion = int(np.amin([np.ceil(itermin * (1 + fraction) ** geom),
                                 lastcheck + np.floor(maxgap)]))
        if k == criterion:
            geom += 1
            lastcheck = k
            if display:
                labels = ([] if force_rPA else ["r", "theta"]) + \
                    [f"f{j}" for j in range(dim - (0 if force_rPA else 2))]
                show_walk_plot(chain[:, :k + 1], labels=labels)
            if (k + 1) >= itermin and konvergence == np.inf:
                if conv_test == "gb":
                    thr0 = int(np.floor(burnin * k))
                    thr1 = int(np.floor((1 - burnin) * k * 0.25))
                    rhat = np.zeros(dim)
                    for j in range(dim):
                        part1 = chain[:, thr0:thr0 + thr1, j].reshape(-1)
                        part2 = chain[:, thr0 + 3 * thr1:thr0 + 4 * thr1,
                                      j].reshape(-1)
                        rhat[j] = gelman_rubin(np.vstack((part1, part2)))
                    if verbosity > 0:
                        print(f"   r_hat = {rhat}")
                        print(f"   r_hat <= threshold = "
                              f"{rhat <= rhat_threshold} \n", flush=True)
                    if (rhat <= rhat_threshold).all():
                        rhat_count += 1
                        if rhat_count >= rhat_count_threshold:
                            if verbosity > 0:
                                print("... ==> convergence reached")
                            konvergence = k
                            stop = konvergence + supp
                    else:
                        rhat_count = 0
                elif conv_test == "ac":
                    for j in range(dim):
                        rhat[j] = autocorr_test(chain[:, :k, j])
                    thr = 1.0 / ac_c
                    if verbosity > 0:
                        print(f"Auto-corr tau/N = {rhat}")
                        print(f"tau/N <= {thr} = {rhat < thr} \n", flush=True)
                    if (rhat <= thr).all():
                        ac_count += 1
                        if verbosity > 0:
                            print(f"Auto-correlation test passed for all "
                                  f"params! {ac_count}/{ac_count_thr}")
                        if ac_count >= ac_count_thr:
                            if verbosity > 0:
                                print("\n ... ==> convergence reached")
                            break
                    else:
                        ac_count = 0
                else:
                    raise ValueError("conv_test value not recognized")

        if k + 1 >= stop:
            if verbosity > 0:
                print("We break the loop because we have reached convergence")
            break

    if k == nIterations - 1 and verbosity > 0:
        print("We have reached the limit # of steps without convergence")
    return chain, lp, n_accepted, k


def chain_zero_truncated(chain):
    """The chain up to its last written step (vip_tpu
    negfc_mcmc.py:488)."""
    try:
        idxzero = np.where(chain[0, :, 0] == 0.0)[0][0]
    except IndexError:
        idxzero = chain.shape[1]
    return chain[:, 0:idxzero, :]


def show_walk_plot(chain, save=False, output_dir="", **kwargs):
    """Walk plot of the chain (vip_tpu negfc_mcmc.py:498)."""
    import matplotlib.pyplot as plt

    nparams = chain.shape[2]
    labels = kwargs.get("labels", [f"p{j}" for j in range(nparams)])
    fig, axes = plt.subplots(nparams, 1, sharex=True,
                             figsize=kwargs.get("figsize", (8, 6)))
    axes = np.atleast_1d(axes)
    for j in range(nparams):
        axes[j].plot(chain[:, :, j].T, color="k", alpha=0.3)
        axes[j].set_ylabel(labels[j])
    axes[-1].set_xlabel("step number")
    if save:
        plt.savefig(output_dir + "walk_plot.pdf")
        plt.close(fig)
    else:
        plt.show()


def show_corner_plot(chain, burnin=0.5, save=False, output_dir="", **kwargs):
    """Corner plot of the posterior samples (vip_tpu
    negfc_mcmc.py:518)."""
    import matplotlib.pyplot as plt

    temp = np.where(chain[0, :, 0] == 0.0)[0]
    if len(temp) != 0:
        chain = chain[:, :temp[0], :]
    length = chain.shape[1]
    chain = chain[:, int(np.floor(burnin * (length - 1))):length, :]
    ndim = chain.shape[2]
    samples = chain.reshape((-1, ndim))
    labels = kwargs.get("labels", [f"p{j}" for j in range(ndim)])
    fig, axes = plt.subplots(ndim, ndim, figsize=(3 * ndim, 3 * ndim))
    axes = np.atleast_2d(axes)
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i][j]
            if j > i:
                ax.axis("off")
            elif i == j:
                ax.hist(samples[:, i], bins=50, histtype="step")
                ax.set_xlabel(labels[i])
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=50)
                ax.set_xlabel(labels[j])
                ax.set_ylabel(labels[i])
    if save:
        plt.savefig(output_dir + "corner_plot.pdf")
        plt.close(fig)
    else:
        plt.show()


def confidence(isamples, cfd=68.27, bins=100, gaussian_fit=False,
               weights=None, verbose=True, save=False, output_dir="",
               force=False, output_file="confidence.txt", title=None,
               ndig=1, plsc=None, labels=["r", "theta", "f"], gt=None,
               *, plot=False, **kwargs):
    """Most probable value and confidence interval of each parameter from
    the histogram of its samples, or the mean and standard deviation with
    ``gaussian_fit`` (vip_tpu negfc_mcmc.py:552; same parameters). vip_tpu
    always draws the histograms; the port draws them (matplotlib) only
    with ``save`` or the keyword-only ``plot``, since the card's machine
    has no matplotlib."""
    isamples = np.asarray(isamples)
    if isamples.ndim == 1:
        isamples = isamples[:, None]
    n_params = isamples.shape[1]
    if n_params != len(labels):
        raise ValueError("Length of labels different to number of "
                         "parameters")
    if cfd == 100:
        cfd = 99.9

    val_max = {}
    confidenceInterval = {}
    mu = np.zeros(n_params)
    sigma_fit = np.zeros(n_params)
    hist_state = []  # per parameter (n, bin_vertices, peak, lo, hi)
    for j in range(n_params):
        n, bin_vertices = np.histogram(isamples[:, j], bins=bins,
                                       weights=weights)
        bins_width = np.mean(np.diff(bin_vertices))
        surface_total = np.sum(np.ones_like(n) * bins_width * n)
        n_arg_sort = np.argsort(n)[::-1]

        test = 0
        k = 0
        for k, jj in enumerate(n_arg_sort):
            test += bins_width * n[int(jj)]
            pourcentage = test / surface_total * 100
            if pourcentage > cfd:
                if verbose:
                    print(f"percentage for {labels[j]}: {pourcentage}%")
                break
        if k == 0:
            msg = ("WARNING: Percentile reached in a single bin. This may "
                   "be due to outliers or a small sample. Uncertainties "
                   "will be unreliable. Try one of these: increase bins, "
                   "or trim outliers, or decrease cfd.")
            # the reference raises when force=True (negfc_mcmc.py:
            # 1660-1669), against its own docstring; kept as vip_tpu does
            if force:
                raise ValueError(msg)
            print(msg)
        n_arg_min = int(n_arg_sort[:k + 1].min())
        n_arg_max = int(n_arg_sort[:k + 1].max())
        if n_arg_min == 0:
            n_arg_min += 1
        if n_arg_max == bins:
            n_arg_max -= 1

        val_max[labels[j]] = bin_vertices[int(n_arg_sort[0]) + 1] \
            - bins_width / 2
        confidenceInterval[labels[j]] = np.array(
            [bin_vertices[n_arg_min - 1], bin_vertices[n_arg_max + 1]]
        ) - val_max[labels[j]]
        hist_state.append((n, bin_vertices, int(n_arg_sort[0]),
                           bin_vertices[n_arg_min - 1],
                           bin_vertices[n_arg_max + 1]))
        if gaussian_fit:
            mu[j] = np.mean(isamples[:, j])
            sigma_fit[j] = np.std(isamples[:, j])

    if save or plot:
        _confidence_figure(isamples, hist_state, val_max, confidenceInterval,
                           labels, gt, title, ndig, bins, weights,
                           gaussian_fit, save, output_dir)

    if verbose:
        print("\n\nConfidence intervals:")
        for j in range(n_params):
            lab = labels[j]
            print(f"{lab}: {val_max[lab]} "
                  f"[{confidenceInterval[lab][0]},"
                  f"{confidenceInterval[lab][1]}]")
        if gaussian_fit:
            print("Gaussian fit results:")
            for j, lab in enumerate(labels):
                print(f"{lab}: {mu[j]} +-{sigma_fit[j]}")

    if save:
        with open(output_dir + output_file, "w") as f:
            f.write("###########################\n")
            f.write("####   INFERENCE TEST   ###\n")
            f.write("###########################\n \n")
            f.write("Results of the MCMC fit\n")
            f.write("----------------------- \n \n")
            f.write(">> Position and flux of the planet (highly "
                    "probable):\n")
            f.write(f"{cfd} % confidence interval\n \n")
            for j, lab in enumerate(labels):
                f.write(f"{lab}: \t\t\t{val_max[lab]:.3f} "
                        f"\t-{-confidenceInterval[lab][0]:.3f} "
                        f"\t+{confidenceInterval[lab][1]:.3f}\n")
            if n_params > 1 and plsc is not None and "r" in labels:
                ci = confidenceInterval["r"] * plsc * 1000
                f.write(f" Platescale = {plsc * 1000} mas\n")
                f.write(f"r (mas): \t\t{val_max['r'] * plsc * 1000:.2f} "
                        f"\t\t-{-ci[0]:.2f} \t\t+{ci[1]:.2f}\n")

    if gaussian_fit:
        return mu, sigma_fit
    return val_max, confidenceInterval


def _confidence_figure(isamples, hist_state, val_max, confidenceInterval,
                       labels, gt, title, ndig, bins, weights, gaussian_fit,
                       save, output_dir):
    """The figure of ``confidence`` (vip_tpu negfc_mcmc.py:623-674): one
    histogram a parameter with the interval's samples shaded and the mode
    marked, and a row of normalized histograms with the Gaussian fit."""
    import matplotlib.pyplot as plt
    from scipy.stats import norm as _norm

    n_params = isamples.shape[1]
    ncols = min(4, n_params)
    hist_rows = max(int(np.ceil(n_params / 4)), 1)
    nrows = 2 * hist_rows if gaussian_fit else hist_rows
    fig, axs = plt.subplots(nrows, ncols, figsize=(12, 4 * nrows),
                            squeeze=False)
    if isinstance(ndig, int):
        ndig = [ndig] * n_params
    for j in range(n_params):
        n, bin_vertices, peak_idx, lo, hi = hist_state[j]
        ax0 = axs[j // 4][j % 4]
        arg = (isamples[:, j] >= lo) & (isamples[:, j] <= hi)
        ax0.hist(isamples[arg, j], bins=bin_vertices, facecolor="gray",
                 edgecolor="darkgray", histtype="stepfilled", alpha=0.5)
        ax0.vlines(val_max[labels[j]], 0, n[peak_idx], linestyles="dashed",
                   color="red", label="estimate" if gt is not None else None)
        if gt is not None:
            ax0.vlines(gt[j], 0, n.max(), linestyles="dashed", color="blue",
                       label="gt")
            ax0.legend()
        ax0.set_xlabel(labels[j])
        if j == 0:
            ax0.set_ylabel("Counts")
        if title is not None:
            fmt = f"{{:.{ndig[j]}f}}".format
            lab = title if isinstance(title, str) else labels[j]
            tit = (f"${{{fmt(val_max[labels[j]])}}}"
                   f"_{{{fmt(confidenceInterval[labels[j]][0])}}}"
                   f"^{{+{fmt(confidenceInterval[labels[j]][1])}}}$")
            ax0.set_title(f"{lab}: {tit}", fontsize=10)
        if gaussian_fit:
            ax1 = axs[hist_rows + j // 4][j % 4]
            _, bins_fit, _ = ax1.hist(isamples[:, j], bins, density=True,
                                      weights=weights, facecolor="gray",
                                      edgecolor="darkgray", histtype="step")
            y = _norm.pdf(bins_fit, np.mean(isamples[:, j]),
                          np.std(isamples[:, j]))
            ax1.plot(bins_fit, y, "g-", linewidth=2, alpha=0.7)
            ax1.vlines(np.mean(isamples[:, j]), 0, np.amax(y),
                       linestyles="dashed", color="green")
            ax1.set_xlabel(labels[j])
            if j == 0:
                ax1.set_ylabel("Counts")
    plt.tight_layout(w_pad=0.1)
    if save:
        fig.savefig(output_dir + "confi_hist_flux_r_theta_gaussfit.pdf")

"""Nested sampling of the NEGFC parameters (port of
``vip_tpu.fm.negfc_nested``).

vip_tpu writes the single-ellipsoid nested sampling of the ``nestle``
package ([SKI04]/[MUK06]/[SHA09]/[FER09]) as host control logic; the port
keeps it, draws from the same numpy ``RandomState`` and evaluates each
likelihood with its own ``lnlike`` (injection and reduction on the
cube's device). matplotlib is imported only to draw.
"""

import numpy as np

from ..config import sep as SEP, time_ini, timing
from ..psfsub.utils_pca import pca_annulus
from .negfc_fmerit import get_mu_and_sigma
from .negfc_mcmc import (confidence, lnlike, show_corner_plot,
                         show_walk_plot)

__all__ = ["nested_negfc_sampling", "nested_sampling_results",
           "NestedResult"]


class NestedResult:
    """Minimal nestle-compatible result container (vip_tpu
    negfc_nested.py:22)."""

    def __init__(self, samples, logl, logwt, logz, logzerr, niter,
                 logvol=None):
        self.samples = samples
        self.logl = logl
        self.logwt = logwt
        self.logz = logz
        self.logzerr = logzerr
        self.niter = niter
        self.weights = np.exp(logwt - logz)
        if logvol is None:
            logvol = np.zeros_like(logwt)
        self.logvol = logvol

    def summary(self):
        return (f"niter: {self.niter}\nlogz: {self.logz:.3f} +/- "
                f"{self.logzerr:.3f}")


def _sample_ellipsoid(points, rstate, enlarge=1.2):
    """Draw a point uniformly from the bounding ellipsoid of ``points``
    (vip_tpu negfc_nested.py:43)."""
    ctr = points.mean(axis=0)
    cov = np.cov(points.T) + 1e-12 * np.eye(points.shape[1])
    # scale so all points are inside
    delta = points - ctr
    icov = np.linalg.inv(cov)
    k = np.einsum("ij,jk,ik->i", delta, icov, delta).max()
    A = np.linalg.cholesky(cov * k * enlarge)
    ndim = points.shape[1]
    # uniform in unit ball
    z = rstate.normal(size=ndim)
    z /= np.linalg.norm(z)
    u = rstate.uniform() ** (1.0 / ndim)
    return ctr + A @ (z * u)


def _nested_sample(loglike, prior_transform, ndim, npoints=100, dlogz=0.1,
                   decline_factor=None, maxiter=20000, rstate=None,
                   verbose=False):
    """Single-ellipsoid nested sampling (nestle 'single' method; vip_tpu
    negfc_nested.py:60)."""
    if rstate is None:
        rstate = np.random.RandomState(0)

    us = rstate.uniform(size=(npoints, ndim))
    vs = np.array([prior_transform(u) for u in us])
    logls = np.array([loglike(v) for v in vs])

    saved_v, saved_logl, saved_logwt, saved_logvol = [], [], [], []
    h = 0.0
    logz = -1e300
    logvol = np.log(1.0 - np.exp(-1.0 / npoints))

    ncall = npoints
    it = 0
    for it in range(maxiter):
        worst = np.argmin(logls)
        logwt = logvol + logls[worst]
        logz_new = np.logaddexp(logz, logwt)
        h = (np.exp(logwt - logz_new) * logls[worst]
             + np.exp(logz - logz_new) * (h + logz)
             - logz_new)
        logz = logz_new
        saved_v.append(np.array(vs[worst]))
        saved_logl.append(logls[worst])
        saved_logwt.append(logwt)
        saved_logvol.append(logvol)

        # replace worst point: sample within the likelihood contour
        logl_star = logls[worst]
        while True:
            u_new = _sample_ellipsoid(us, rstate)
            if np.any(u_new < 0) or np.any(u_new > 1):
                continue
            v_new = prior_transform(u_new)
            logl_new = loglike(v_new)
            ncall += 1
            if logl_new > logl_star:
                us[worst] = u_new
                vs[worst] = v_new
                logls[worst] = logl_new
                break

        logvol -= 1.0 / npoints

        # stopping criterion
        logz_remain = np.max(logls) + logvol
        if np.logaddexp(logz, logz_remain) - logz < dlogz:
            break
        if decline_factor is not None and it > 2 * npoints:
            recent = saved_logwt[-int(decline_factor * npoints):]
            if len(recent) > 2 and max(recent) < logz - np.log(1e4):
                break
        if verbose and it % 200 == 0:
            print(f"it={it}  logz={logz:.3f}  ncall={ncall}")

    # add remaining live points
    logvol_live = -it / npoints - np.log(npoints)
    for i in range(npoints):
        saved_v.append(np.array(vs[i]))
        saved_logl.append(logls[i])
        saved_logwt.append(logvol_live + logls[i])
        saved_logvol.append(logvol_live)
        logz = np.logaddexp(logz, logvol_live + logls[i])

    samples = np.array(saved_v)
    logl = np.array(saved_logl)
    logwt = np.array(saved_logwt)
    logzerr = np.sqrt(abs(h) / npoints) if np.isfinite(h) else 0.0
    return NestedResult(samples, logl, logwt, logz, logzerr, it + 1,
                        logvol=np.array(saved_logvol))


def nested_negfc_sampling(init, cube, angs, psfn, fwhm, mu_sigma=True,
                          sigma="spe+pho", fmerit="sum", annulus_width=8,
                          aperture_radius=1, ncomp=10, scaling=None,
                          svd_mode="lapack", cube_ref=None,
                          collapse="median", algo=pca_annulus, delta_rot=1,
                          algo_options={}, weights=None, w=(5, 5, 200),
                          method="single", npoints=100, dlogz=0.1,
                          decline_factor=None, rstate=None, verbose=True):
    """Nested sampling of (r, theta, f) in the box ``init`` +- ``w`` (vip_tpu
    negfc_nested.py:136; same parameters). Returns a ``NestedResult``."""
    init = np.asarray(init, dtype=float)

    mu_sig = get_mu_and_sigma(cube, angs, ncomp, annulus_width,
                              aperture_radius, fwhm, init[0], init[1],
                              init[2], psfn, cube_ref=cube_ref,
                              svd_mode=svd_mode, scaling=scaling, algo=algo,
                              delta_rot=delta_rot, collapse=collapse,
                              algo_options=algo_options)
    if isinstance(mu_sigma, tuple):
        if len(mu_sigma) != 2:
            raise TypeError("if a tuple, mu_sigma should have 2 elements")
    elif mu_sigma:
        mu_sigma = mu_sig
        if verbose:
            print("The mean and stddev in the annulus at the radius of the "
                  f"companion are {mu_sigma[0]:.2f} and {mu_sigma[1]:.2f} "
                  "respectively.")
    else:
        mu_sigma = mu_sig[0]

    def prior_transform(x):
        rmin = init[0] - w[0]
        rmax = init[0] + w[0]
        r = np.sqrt((rmax**2 - rmin**2) * x[0] + rmin**2)
        tmin = init[1] - w[1]
        tmax = init[1] + w[1]
        t = x[1] * (tmax - tmin) + tmin
        fmin = max(init[2] - w[2], 0)
        fmax = init[2] + w[2]
        f = (x[2] * (np.sqrt(fmax) - np.sqrt(fmin)) + np.sqrt(fmin)) ** 2
        return np.array([r, t, f])

    def loglike(param):
        return lnlike(param=param, cube=cube, angs=angs, psf_norm=psfn,
                      fwhm=fwhm, annulus_width=annulus_width, ncomp=ncomp,
                      aperture_radius=aperture_radius, initial_state=init,
                      cube_ref=cube_ref, svd_mode=svd_mode, scaling=scaling,
                      algo=algo, delta_rot=delta_rot, fmerit=fmerit,
                      collapse=collapse, algo_options=algo_options,
                      weights=weights, mu_sigma=mu_sigma, sigma=sigma)

    if verbose:
        start = time_ini()
        print("Prior bounds on parameters:")
        print(f"Radius [{init[0] - w[0]},{init[0] + w[0]}]")
        print(f"Theta [{init[1] - w[1]},{init[1] + w[1]}]")
        print(f"Flux [{max(init[2] - w[2], 0)},{init[2] + w[2]}]")
        print(f"\nUsing {npoints} active points")

    res = _nested_sample(loglike, prior_transform, 3, npoints=npoints,
                         dlogz=dlogz, decline_factor=decline_factor,
                         rstate=rstate, verbose=verbose)

    if verbose:
        print(f"\nTotal running time:")
        timing(start)
    return res


def _weighted_mean_and_cov(x, weights):
    """Weighted sample mean and unbiased weighted covariance (the math of
    nestle.mean_and_cov; vip_tpu negfc_nested.py:204)."""
    mean = np.average(x, weights=weights, axis=0)
    dx = x - mean
    wsum = np.sum(weights)
    w2sum = np.sum(weights ** 2)
    cov = (wsum / (wsum ** 2 - w2sum)) * np.einsum("i,ij,ik->jk", weights,
                                                   dx, dx)
    return mean, cov


def nested_sampling_results(ns_object, burnin=0.4, bins=None, cfd=68.27,
                            save=False, output_dir="/", plot=False,
                            verbose=True):
    """Best-fit parameters and 1-sigma uncertainties from a nested-sampling
    result: weighted mean +- sqrt(covariance diagonal), shape (3, 2)
    (vip_tpu negfc_nested.py:216; same parameters)."""
    res = ns_object
    nsamples = res.samples.shape[0]
    indburnin = int(np.percentile(np.arange(nsamples), burnin * 100))

    if verbose:
        print(res.summary())
        print("\nNatural log of prior volume and Weight corresponding to "
              "each sample")
    if save or plot:
        import matplotlib.pyplot as plt

        plt.figure(figsize=(12, 4))
        for k, (vec, ylab) in enumerate(((res.logvol, "logvol"),
                                         (res.weights, "weights"))):
            plt.subplot(1, 2, k + 1)
            plt.plot(vec, ".", alpha=0.5, color="gray")
            plt.xlabel("samples")
            plt.ylabel(ylab)
            plt.vlines(indburnin, np.min(vec), np.max(vec),
                       linestyles="dotted")
        if save:
            plt.savefig(output_dir + "Nested_results.pdf")
        if plot:
            plt.show()

        if verbose:
            print("\nWalk plots before the burnin")
        show_walk_plot(np.expand_dims(res.samples, axis=0))
        if burnin > 0:
            if verbose:
                print("\nWalk plots after the burnin")
            show_walk_plot(np.expand_dims(res.samples[indburnin:], axis=0))
        if save:
            plt.savefig(output_dir + "Nested_walk_plots.pdf")
        if plot:
            plt.show()

    mean, cov = _weighted_mean_and_cov(res.samples[indburnin:],
                                       res.weights[indburnin:])
    if verbose:
        print("\nWeighted mean +- sqrt(covariance)")
        print(f"Radius = {mean[0]:.3f} +/- {np.sqrt(cov[0, 0]):.3f}")
        print(f"Theta = {mean[1]:.3f} +/- {np.sqrt(cov[1, 1]):.3f}")
        print(f"Flux = {mean[2]:.3f} +/- {np.sqrt(cov[2, 2]):.3f}")

    if save:
        with open(output_dir + "Nested_sampling.txt", "w") as f:
            f.write("#################################\n")
            f.write("####   CONFIDENCE INTERVALS   ###\n")
            f.write("#################################\n \n")
            f.write("Results of the NESTED SAMPLING fit\n")
            f.write("----------------------------------\n \n")
            f.write("\nWeighted mean +- sqrt(covariance)\n")
            f.write(f"Radius = {mean[0]:.3f} +/- "
                    f"{np.sqrt(cov[0, 0]):.3f}\n")
            f.write(f"Theta = {mean[1]:.3f} +/- "
                    f"{np.sqrt(cov[1, 1]):.3f}\n")
            f.write(f"Flux = {mean[2]:.3f} +/- {np.sqrt(cov[2, 2]):.3f}\n")

    if bins is None:
        bins = int(np.sqrt(res.samples[indburnin:].shape[0]))
        if verbose:
            print("\nHist bins =", bins)

    if save or plot:
        show_corner_plot(res.samples[indburnin:][None], burnin=0)
        if save:
            import matplotlib.pyplot as plt

            plt.savefig(output_dir + "Nested_corner.pdf")

    if verbose:
        print("\nConfidence intervals")
    if save or plot:
        _ = confidence(res.samples[indburnin:], cfd=cfd, bins=bins,
                       weights=res.weights[indburnin:], gaussian_fit=True,
                       verbose=verbose, save=False, plot=True)
        if save:
            import matplotlib.pyplot as plt

            plt.savefig(output_dir
                        + "Nested_confi_hist_flux_r_theta_gaussfit.pdf")

    final_res = np.array([[mean[0], np.sqrt(cov[0, 0])],
                          [mean[1], np.sqrt(cov[1, 1])],
                          [mean[2], np.sqrt(cov[2, 2])]])
    return final_res

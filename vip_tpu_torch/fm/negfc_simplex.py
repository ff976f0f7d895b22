"""NEGFC first guess: a flux grid, then a Nelder-Mead simplex (port of
``vip_tpu.fm.negfc_simplex``).

Both steps run on the host (numpy, scipy's ``minimize``) and call
``chisquare``, whose injection and reduction run on the cube's device:
pass the cube as a CUDA tensor to keep it on the card between the calls.
A 4-d cube has one flux a channel (the grid searched channel by channel,
the others at 0, and all fluxes in the simplex), or one for all with
``bin_spec``.
"""

import numpy as np
from scipy.optimize import minimize

from ..config import sep, time_ini, timing
from ..psfsub.utils_pca import pca_annulus
from ..var.coords import frame_center
from .negfc_fmerit import _check_cube, chisquare, get_mu_and_sigma

__all__ = ["firstguess", "firstguess_from_coord", "firstguess_simplex"]


def firstguess_from_coord(planet, center, cube, angs, psfn, fwhm,
                          annulus_width, aperture_radius, ncomp=1,
                          cube_ref=None, svd_mode="lapack", scaling=None,
                          fmerit="sum", imlib="vip-fft",
                          interpolation="lanczos4", collapse="median",
                          algo=pca_annulus, delta_rot=1, algo_options={},
                          f_range=None, transmission=None,
                          radial_gradient=True, mu_sigma=(0, 1),
                          weights=None, ndet=None, bin_spec=False,
                          plot=False, verbose=True, save=False, debug=False,
                          full_output=False):
    """(r, theta, flux) of the companion at pixel ``planet`` = (x, y):
    the flux of least χ² on the grid ``f_range`` (default 30 values from
    0.1 to 1e4, geometric), the search stopping after the fourth rise of
    χ² (vip_tpu negfc_simplex.py:19; same parameters). With
    ``full_output`` also the grid and its χ² curve. A 4-d cube without
    ``bin_spec`` searches each channel's flux with the others at 0 and
    returns (r, theta, f_1, ..., f_z), with the list of the curves."""
    _check_cube(cube)
    planet = np.asarray(planet, dtype=float)
    center = np.asarray(center, dtype=float)
    xy = planet - center
    r0 = np.sqrt(xy[0] ** 2 + xy[1] ** 2)
    theta0 = np.mod(np.arctan2(xy[1], xy[0]) / np.pi * 180, 360)
    f_range = np.geomspace(1e-1, 1e4, 30) if f_range is None \
        else np.asarray(f_range)

    def grid_search(ch):
        chi2r = []
        if verbose:
            print("Step | flux    | chi2r")
        counter = 0
        for j, f_guess in enumerate(f_range):
            if ch is None:
                params = (r0, theta0, f_guess)
            else:
                fluxes = [0] * cube.shape[0]
                fluxes[ch] = f_guess
                params = tuple([r0, theta0] + fluxes)
            chi2r.append(chisquare(params, cube, angs, psfn, fwhm,
                                   annulus_width, aperture_radius,
                                   (r0, theta0), ncomp, cube_ref, svd_mode,
                                   scaling, fmerit, collapse, algo,
                                   delta_rot, imlib, interpolation,
                                   algo_options, transmission,
                                   radial_gradient, mu_sigma, weights,
                                   False, ndet, bin_spec, debug))
            if chi2r[j] > chi2r[j - 1]:
                counter += 1
            if counter == 4:
                break
            if verbose:
                print(f"{j + 1}/{f_range.shape[0]}   {f_guess:.3f}   "
                      f"{chi2r[j]:.3f}")
        return np.array(chi2r)

    if cube.ndim == 3 or bin_spec:
        chi2r = grid_search(None)
        res = (r0, theta0, f_range[chi2r.argmin()])
        if plot:
            _plot_chi2r(f_range, chi2r, save)
    else:
        chi2r = [grid_search(ch) for ch in range(cube.shape[0])]
        res = tuple([r0, theta0] + [f_range[c.argmin()] for c in chi2r])
        if plot:
            for c in chi2r:
                _plot_chi2r(f_range, c, save)
    if full_output:
        return res, f_range, chi2r
    return res


def _plot_chi2r(f_range, chi2r, save):
    """The χ² curve against the flux (vip_tpu negfc_simplex.py:75)."""
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 4))
    plt.title(r"$\chi^2_{r}$ vs flux")
    plt.xlim(f_range[0], f_range[:chi2r.shape[0]].max())
    plt.ylim(chi2r.min() * 0.9, chi2r.max() * 1.1)
    plt.plot(f_range[:chi2r.shape[0]], chi2r, linestyle="-", marker=".",
             markerfacecolor="r", markeredgecolor="r", color="gray")
    plt.xlabel("flux")
    plt.ylabel(r"$\chi^2_r$")
    plt.grid("on")
    if save:
        plt.savefig("chi2rVSflux.pdf")
    plt.show()


def firstguess_simplex(p, cube, angs, psfn, ncomp, fwhm, annulus_width,
                       aperture_radius, cube_ref=None, svd_mode="lapack",
                       scaling=None, fmerit="sum", imlib="vip-fft",
                       interpolation="lanczos4", collapse="median",
                       algo=pca_annulus, delta_rot=1, algo_options={},
                       p_ini=None, transmission=None, radial_gradient=False,
                       mu_sigma=(0, 1), weights=None, force_rPA=False,
                       ndet=None, bin_spec=False, options=None, verbose=False,
                       **kwargs):
    """Nelder-Mead minimization of ``chisquare`` from ``p`` (vip_tpu
    negfc_simplex.py:123; same parameters and defaults, which are
    vip_tpu's: the exact FFT rotation, not the reference's 'skimage'
    biquintic). Returns scipy's ``OptimizeResult``."""
    if verbose:
        print("\nNelder-Mead minimization is running...")
    if p_ini is None:
        p_ini = p
    if force_rPA:
        p_t = p[2:]
        p_ini = (p[0], p[1])
    else:
        p_t = p
    solu = minimize(chisquare, p_t,
                    args=(cube, angs, psfn, fwhm, annulus_width,
                          aperture_radius, p_ini, ncomp, cube_ref, svd_mode,
                          scaling, fmerit, collapse, algo, delta_rot, imlib,
                          interpolation, algo_options, transmission,
                          radial_gradient, mu_sigma, weights, force_rPA,
                          ndet, bin_spec),
                    method="Nelder-Mead", options=options, **kwargs)
    if verbose:
        print(solu)
    return solu


def firstguess(cube, angs, psfn, planets_xy_coord, ncomp=1, fwhm=4,
               annulus_width=4, aperture_radius=1, cube_ref=None,
               svd_mode="lapack", scaling=None, fmerit="sum",
               imlib="vip-fft", interpolation="lanczos4", collapse="median",
               algo=pca_annulus, delta_rot=1, f_range=None,
               transmission=None, radial_gradient=False, mu_sigma=True,
               wedge=None, weights=None, force_rPA=False, ndet=None,
               bin_spec=False, algo_options={}, simplex=True,
               simplex_options=None, plot=False, verbose=True, save=False):
    """First guess of (r, theta, flux) of each planet at the pixels
    ``planets_xy_coord``: the flux grid, then the simplex (vip_tpu
    negfc_simplex.py:163; same parameters). With ``mu_sigma`` True the
    merit is the χ² of the annulus statistics of ``get_mu_and_sigma``.
    Returns the (n_planet,) arrays r_0, theta_0, f_0 (f_0 (n_planet,
    channels) for a 4-d cube without ``bin_spec``)."""
    _check_cube(cube)
    if verbose:
        start_time = time_ini()

    planets_xy_coord = np.atleast_2d(np.array(planets_xy_coord, dtype=float))
    n_planet = planets_xy_coord.shape[0]
    center_xy_coord = np.array(frame_center(cube))
    r_0 = np.zeros(n_planet)
    theta_0 = np.zeros_like(r_0)
    one_flux = cube.ndim == 3 or bin_spec
    if one_flux:
        f_0 = np.zeros_like(r_0)
    else:
        if psfn.ndim < 3:
            raise TypeError("The normalized PSF should be 3D for a 4D input "
                            "cube")
        f_0 = np.zeros([n_planet, cube.shape[0]])

    if weights is not None:
        if not len(weights) == cube.shape[-3]:
            raise TypeError("Weights should have same length as temporal "
                            "cube axis")
        norm_weights = weights / np.sum(weights)
    else:
        norm_weights = weights

    for i_planet in range(n_planet):
        if verbose:
            print("\n" + sep)
            print(f"             Planet {i_planet}           ")
            print(sep + "\n")
            print(f"Planet {i_planet}: flux estimation at the position "
                  f"[{planets_xy_coord[i_planet, 0]},"
                  f"{planets_xy_coord[i_planet, 1]}], running ...")

        mu_sigma_i = mu_sigma
        if isinstance(mu_sigma, tuple):
            if len(mu_sigma) != 2:
                raise TypeError("If a tuple, mu_sigma must have 2 elements")
        elif mu_sigma is not None:
            xy = planets_xy_coord[i_planet] - center_xy_coord
            r0 = np.sqrt(xy[0] ** 2 + xy[1] ** 2)
            theta0 = np.mod(np.arctan2(xy[1], xy[0]) / np.pi * 180, 360)
            mu_sigma_i = get_mu_and_sigma(
                cube, angs, ncomp, annulus_width, aperture_radius, fwhm, r0,
                theta0, cube_ref=cube_ref, wedge=wedge, svd_mode=svd_mode,
                scaling=scaling, algo=algo, delta_rot=delta_rot, imlib=imlib,
                interpolation=interpolation, collapse=collapse,
                weights=norm_weights, algo_options=algo_options,
                bin_spec=bin_spec)

        res_init = firstguess_from_coord(
            planets_xy_coord[i_planet], center_xy_coord, cube, angs, psfn,
            fwhm, annulus_width, aperture_radius, ncomp, f_range=f_range,
            cube_ref=cube_ref, svd_mode=svd_mode, scaling=scaling,
            fmerit=fmerit, imlib=imlib, collapse=collapse, algo=algo,
            delta_rot=delta_rot, interpolation=interpolation,
            algo_options=algo_options, transmission=transmission,
            radial_gradient=radial_gradient, mu_sigma=mu_sigma_i,
            weights=weights, ndet=ndet, bin_spec=bin_spec, plot=plot,
            verbose=verbose, save=save)
        r_pre, theta_pre, f_pre = res_init[0], res_init[1], res_init[2:]
        if verbose:
            print(f"Planet {i_planet}: preliminary position guess: "
                  f"(r, theta)=({r_pre:.1f}, {theta_pre:.1f})")
            print(f"Planet {i_planet}: preliminary flux guess: "
                  + ", ".join(f"{fz:.2f}" for fz in f_pre))

        if simplex or force_rPA:
            if verbose:
                print(f"Planet {i_planet}: Simplex Nelder-Mead minimization,"
                      " running ...")
            if simplex_options is None:
                simplex_options = {"xatol": 1e-6, "fatol": 1e-6,
                                   "maxiter": 800, "maxfev": 2000}
            res = firstguess_simplex(
                res_init, cube, angs, psfn, ncomp, fwhm,
                annulus_width, aperture_radius, cube_ref=cube_ref,
                svd_mode=svd_mode, scaling=scaling, fmerit=fmerit,
                imlib=imlib, interpolation=interpolation, collapse=collapse,
                algo=algo, delta_rot=delta_rot, algo_options=algo_options,
                transmission=transmission, radial_gradient=radial_gradient,
                mu_sigma=mu_sigma_i, weights=weights, force_rPA=force_rPA,
                ndet=ndet, bin_spec=bin_spec, options=simplex_options,
                verbose=False)
            if force_rPA:
                r_0[i_planet], theta_0[i_planet] = r_pre, theta_pre
                f_0[i_planet] = res.x[0] if one_flux else res.x[:]
            else:
                r_0[i_planet], theta_0[i_planet] = res.x[0], res.x[1]
                f_0[i_planet] = res.x[2] if one_flux else res.x[2:]
            if verbose:
                print(f"Planet {i_planet}: Success: {res.success}, nit: "
                      f"{res.nit}, nfev: {res.nfev}, chi2r: {res.fun}")
                print(f"message: {res.message}")
        else:
            if verbose:
                print(f"Planet {i_planet}: Simplex Nelder-Mead minimization "
                      "skipped.")
            r_0[i_planet], theta_0[i_planet] = r_pre, theta_pre
            f_0[i_planet] = f_pre[0] if one_flux else f_pre

    if verbose:
        print("\n", sep, "\nDONE !\n", sep)
        timing(start_time)
    return r_0, theta_0, f_0

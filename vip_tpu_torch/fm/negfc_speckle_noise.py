"""Speckle-noise uncertainty on NEGFC parameters (port of
``vip_tpu.fm.negfc_speckle_noise``): inject the companion at a range of
azimuths into the planet-free cube, refit each with the simplex (its
reductions on the cube's device), and fit a Gaussian to the offsets.
The azimuths run one after another (the port's serial ``pool_map``).
"""

import numpy as np

from ..config.utils_conf import iterable, pool_map
from ..psfsub.utils_pca import pca_annulus
from .fakecomp import cube_inject_companions, cube_planet_free
from .negfc_fmerit import _check_cube, get_mu_and_sigma
from .negfc_mcmc import confidence
from .negfc_simplex import firstguess_simplex

__all__ = ["speckle_noise_uncertainty"]


def speckle_noise_uncertainty(cube, p_true, angle_range, derot_angles, algo,
                              psfn, fwhm, aperture_radius, opp_ang=False,
                              indep_ap=False, cube_ref=None, fmerit="sum",
                              algo_options={}, transmission=None,
                              radial_gradient=False, mu_sigma=None,
                              wedge=None, weights=None, force_rPA=False,
                              ndet=None, nproc=None, simplex_options=None,
                              bins=None, save=False, output=None,
                              verbose=True, full_output=True, plot=False,
                              sigma_trim=None):
    """Speckle-noise uncertainty by injection and refit at the azimuths
    ``angle_range`` (vip_tpu negfc_speckle_noise.py:20; same parameters):
    ``p_true`` (r, theta, f), or (r, theta, f_1, ..., f_z) for a 4-d
    cube."""
    _check_cube(cube)
    if verbose:
        print("")
        print("#######################################################")
        print("###            SPECKLE NOISE DETERMINATION          ###")
        print("#######################################################")
        print("")

    if len(p_true) == 3:
        r_true, theta_true, f_true = p_true
        nch = 1
    elif len(p_true) > 3 and cube.ndim == 4 and \
            cube.shape[0] == len(p_true) - 2:
        r_true = p_true[0]
        theta_true = p_true[1]
        f_true = np.array(p_true[2:])
        nch = cube.shape[0]
    else:
        raise TypeError(f"cube ndim ({cube.ndim}) and parameter length "
                        f"({len(p_true)}) combo not accepted")

    angle_range = np.asarray(angle_range, dtype=float)
    if indep_ap:
        angle_span = angle_range[-1] - angle_range[0]
        n_ap = int(np.deg2rad(angle_span) * r_true / fwhm)
        delta_theta = angle_span / n_ap
        angle_range = np.linspace(angle_range[0] + delta_theta / 2,
                                  angle_range[-1] + delta_theta / 2, n_ap,
                                  endpoint=False)
    if angle_range[0] % 360 == angle_range[-1] % 360:
        angle_range = angle_range[:-1]

    if verbose:
        print(f"Number of steps: {angle_range.shape[0]}")
        print("")

    imlib = algo_options.get("imlib", "vip-fft")
    interpolation = algo_options.get("interpolation", "lanczos4")

    if len(p_true) == 3:
        planet_parameter = np.array([[r_true, theta_true, f_true]])
    else:
        planet_parameter = np.zeros([1, 3, nch])
        planet_parameter[0, 0, :] = r_true
        planet_parameter[0, 1, :] = theta_true
        planet_parameter[0, 2] = f_true
    cube_pf = cube_planet_free(planet_parameter, cube, derot_angles, psfn,
                               imlib=imlib, interpolation=interpolation,
                               transmission=transmission,
                               radial_gradient=radial_gradient)

    if isinstance(mu_sigma, tuple):
        if len(mu_sigma) != 2:
            raise TypeError("If a tuple, mu_sigma must have 2 elements")
    elif mu_sigma is not None:
        ncomp = algo_options.get("ncomp", 1)
        annulus_width = algo_options.get("annulus_width", int(fwhm))
        if weights is not None:
            if not len(weights) == cube.shape[0]:
                raise TypeError("Weights should have same length as cube "
                                "axis 0")
            norm_weights = weights / np.sum(weights)
        else:
            norm_weights = weights
        mu_sigma = get_mu_and_sigma(cube, derot_angles, ncomp, annulus_width,
                                    aperture_radius, fwhm, r_true,
                                    theta_true, f_true, psfn,
                                    cube_ref=cube_ref, wedge=wedge,
                                    algo=algo, weights=norm_weights,
                                    algo_options=algo_options)

    # per-angle simplex refits through pool_map, one after another

    residuals = np.array(pool_map(
        nproc, _estimate_speckle_one_angle, iterable(angle_range), cube_pf,
        psfn, derot_angles, r_true, f_true, fwhm, aperture_radius, cube_ref,
        fmerit, algo, algo_options, transmission, radial_gradient, mu_sigma,
        weights, force_rPA, ndet, simplex_options, imlib, interpolation,
        verbose=verbose))
    if opp_ang:
        residuals2 = np.array(pool_map(
            nproc, _estimate_speckle_one_angle, iterable(angle_range),
            cube_pf, psfn, -derot_angles, r_true, f_true, fwhm,
            aperture_radius, cube_ref, fmerit, algo, algo_options,
            transmission, radial_gradient, mu_sigma, weights, force_rPA,
            ndet, simplex_options, imlib, interpolation, verbose=verbose))
        residuals = np.concatenate((residuals, residuals2))

    p_simp_stack = [residuals[:, 0], residuals[:, 1]]
    for ch in range(nch):
        p_simp_stack.append(residuals[:, 2 + ch])
    p_simplex = np.transpose(np.vstack(p_simp_stack))
    p_off_stack = [residuals[:, nch + 2], residuals[:, nch + 3]]
    for ch in range(nch):
        p_off_stack.append(residuals[:, nch + 4 + ch])
    offset = np.transpose(np.vstack(p_off_stack))
    chi2 = residuals[:, int(2 * nch) + 4]
    nit = residuals[:, int(2 * nch) + 5]
    success = residuals[:, int(2 * nch) + 6]

    if save:
        speckles = {"r_true": r_true, "angle_range": angle_range,
                    "f_true": f_true, "r_simplex": residuals[:, 0],
                    "theta_simplex": residuals[:, 1], "offset": offset,
                    "chi2": chi2, "nit": nit, "success": success}
        import pickle

        with open(output or "speckle_noise.pkl", "wb") as f:
            pickle.dump(speckles, f)

    if force_rPA:
        offset = offset[:, 2:]
    if sigma_trim:
        std = np.std(offset, axis=0)
        trim_offset = [offset[i] for i in range(offset.shape[0])
                       if np.all(np.abs(offset[i]) < sigma_trim * std)]
        offset = np.array(trim_offset)

    if bins is None:
        bins = int(offset.shape[0] / 6)

    labels = [] if force_rPA else ["r", "theta"]
    if cube.ndim == 3:
        labels.append("f")
    else:
        for ch in range(nch):
            labels.append(f"f{ch}")

    mean_dev, sp_unc = confidence(offset, cfd=68.27, bins=max(bins, 2),
                                  gaussian_fit=True, verbose=verbose,
                                  save=False, output_dir="", labels=labels,
                                  force=True, plot=plot)
    if plot:
        import matplotlib.pyplot as plt

        plt.show()
    if full_output:
        return sp_unc, mean_dev, p_simplex, offset, chi2, nit, success
    return sp_unc


def _estimate_speckle_one_angle(angle, cube_pf, psfn, angs, r_true, f_true,
                                fwhm, aperture_radius, cube_ref, fmerit,
                                algo, algo_options, transmission,
                                radial_gradient, mu_sigma, weights,
                                force_rPA, ndet, simplex_options, imlib,
                                interpolation, verbose=True):
    """Inject at one azimuth, refit with the simplex (vip_tpu
    negfc_speckle_noise.py:175)."""
    if verbose:
        print(f"Process is running for angle: {angle:.2f}")

    cube_fc = cube_inject_companions(cube_pf, psfn, angs, flevel=f_true,
                                     rad_dists=[r_true], n_branches=1,
                                     theta=angle, transmission=transmission,
                                     radial_gradient=radial_gradient,
                                     imlib=imlib,
                                     interpolation=interpolation,
                                     verbose=False)
    if cube_pf.ndim == 4:
        p_ini = tuple([r_true, angle] + list(f_true))
    else:
        p_ini = (r_true, angle, f_true)

    ncomp = algo_options.get("ncomp", 1)
    annulus_width = algo_options.get("annulus_width", int(fwhm))
    delta_rot = algo_options.get("delta_rot", 1)

    res_simplex = firstguess_simplex(
        p_ini, cube_fc, angs, psfn, ncomp, fwhm, annulus_width,
        aperture_radius, cube_ref=cube_ref, fmerit=fmerit, algo=algo,
        delta_rot=delta_rot, algo_options=algo_options, imlib=imlib,
        interpolation=interpolation, transmission=transmission,
        radial_gradient=radial_gradient, mu_sigma=mu_sigma, weights=weights,
        force_rPA=force_rPA, ndet=ndet, options=simplex_options,
        verbose=False)

    res = []
    if cube_pf.ndim == 3:
        if force_rPA:
            (simplex_res_f,) = res_simplex.x
            simplex_res_r, simplex_res_PA = r_true, angle
        else:
            simplex_res_r, simplex_res_PA, simplex_res_f = res_simplex.x
        res.append(simplex_res_r)
        res.append(simplex_res_PA)
        res.append(simplex_res_f)
        res.append(simplex_res_r - r_true)
        res.append(simplex_res_PA - angle)
        res.append(simplex_res_f - f_true)
    else:
        if force_rPA:
            simplex_res_f = np.array(res_simplex.x)
            simplex_res_r, simplex_res_PA = r_true, angle
        else:
            simplex_res_r = res_simplex.x[0]
            simplex_res_PA = res_simplex.x[1]
            simplex_res_f = np.array(res_simplex.x[2:])
        res.append(simplex_res_r)
        res.append(simplex_res_PA)
        res.extend(list(np.atleast_1d(simplex_res_f)))
        res.append(simplex_res_r - r_true)
        res.append(simplex_res_PA - angle)
        res.extend(list(np.atleast_1d(simplex_res_f - f_true)))

    res.append(res_simplex.fun)
    res.append(res_simplex.nit)
    res.append(res_simplex.success)
    return res

"""First guess of the disk model's shift, rotation, scaling and flux for
NEGFD (port of ``vip_tpu.fm.negfd_simplex``): a grid search of the flux,
then scipy's Nelder-Mead simplex on the host, as NEGFC's. Every χ² runs
on the cube's device (``chisquare_fd``); the cube and the model go there
once, at the entry point.
"""

import numpy as np
from scipy.optimize import minimize

from ..config.device import as_tensor
from ..config.timing import time_ini, timing
from ..config.utils_conf import sep as SEP
from ..psfsub.pca_fullfr import pca
from .negfd_fmerit import chisquare_fd

__all__ = ["firstguess_fd", "firstguess_fd_from_coord"]


def firstguess_fd_from_coord(disk_xy, disk_theta, disk_scal, cube, angs,
                             disk_img, mask_fm, fmerit="sum", mu_sigma=None,
                             f_range=None, psfn=None, algo=pca,
                             algo_options={}, interp_order=-1,
                             imlib="skimage", interpolation="biquintic",
                             transmission=None, weights=None, plot=False,
                             verbose=True, save=False, debug=False,
                             full_output=False, rot_options={}):
    """Grid-search the disk flux scaling at fixed shift, rotation and
    scaling (vip_tpu negfd_simplex.py:14)."""
    cube = as_tensor(cube)
    disk_img = as_tensor(disk_img, cube.device, cube.dtype)
    if len(disk_xy) != 2:
        raise ValueError("'disk_xy' should have 2 elements")
    x0, y0 = disk_xy
    theta0 = disk_theta
    scal0 = disk_scal

    if f_range is not None:
        f_range = np.asarray(f_range)
        n = f_range.shape[0]
    else:
        n = 30
        f_range = np.geomspace(1e-1, 1e4, n)

    def _grid_search_f(ch, cube_, disk_img_):
        chi2r = []
        if verbose:
            print("Step | flux    | chi2r")
        counter = 0
        for j, f_guess in enumerate(f_range):
            if cube_.ndim == 3:
                params = (f_guess,)
            elif ch is not None and cube_.ndim == 4:
                fluxes = [0] * cube_.shape[0]
                fluxes[ch] = f_guess
                params = tuple(fluxes)
            else:
                raise TypeError("If cube is 4d, channel index must be "
                                "provided")
            inistate = (x0, y0, theta0, scal0)
            force_params = (1, 1, 1, 1, 0)
            chi2r.append(chisquare_fd(params, cube_, angs, disk_img_,
                                      mask_fm, inistate, force_params, None,
                                      fmerit, mu_sigma, psfn, algo,
                                      algo_options, interp_order, imlib,
                                      interpolation, transmission, weights,
                                      debug, rot_options))
            if chi2r[j] > chi2r[j - 1]:
                counter += 1
            if counter == 4:
                break
            if verbose:
                print("{}/{}   {:.3f}   {:.3f}".format(j + 1, n, f_guess,
                                                       chi2r[j]))
        return chi2r

    def _plot_chi2r(curves):
        """One overlaid figure for all channels with a legend when
        labeled (one figure/one saved pdf, like the reference's
        multi-channel branch in negfc_simplex.py:300-334)."""
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8, 4))
        plt.title(r"$\chi^2_{r}$ vs flux")
        lo = min(c.min() for _, c in curves)
        hi = max(c.max() for _, c in curves)
        plt.xlim(f_range[0],
                 max(f_range[:c.shape[0]].max() for _, c in curves))
        plt.ylim(lo * 0.95, hi * 1.05)
        for label, chi2r_arr in curves:
            plt.plot(f_range[:chi2r_arr.shape[0]], chi2r_arr, linestyle="-",
                     marker=".", markerfacecolor="r", markeredgecolor="r",
                     color="gray" if label is None else None, label=label)
        plt.xlabel("flux")
        plt.ylabel(r"$\chi^2_r$")
        plt.grid("on")
        if any(label is not None for label, _ in curves):
            plt.legend()
        if save:
            plt.savefig("chi2rVSflux.pdf")
        plt.show()

    if cube.ndim == 3 or "scale_list" in algo_options.keys():
        chi2r = np.array(_grid_search_f(None, cube, disk_img))
        f0 = f_range[chi2r.argmin()]
        res = (x0, y0, theta0, scal0, f0)
        if plot:
            _plot_chi2r([(None, chi2r)])
    else:
        f0 = []
        chi2r = []
        for i in range(cube.shape[0]):
            if verbose:
                print("Processing spectral channel {}...".format(i))
            chi2r_tmp = _grid_search_f(i, cube[i], disk_img[i])
            chi2r.append(chi2r_tmp)
            chi2r_tmp = np.array(chi2r_tmp)
            f0.append(f_range[chi2r_tmp.argmin()])
            if verbose:
                print("... optimal grid flux: {:.3f} (chi2r = {:.1f})"
                      .format(f0[i], np.amin(chi2r_tmp)))
        if plot:
            _plot_chi2r([(f"ch. {i}", np.asarray(c))
                         for i, c in enumerate(chi2r)])
        res = tuple([x0, y0, theta0, scal0] + f0)

    if full_output:
        return res, f_range, chi2r
    return res


def firstguess_fd_simplex(p, cube, angs, disk_model, mask_fm,
                          grid_params_list=None, fmerit="sum", mu_sigma=None,
                          force_params=None, options=None, psfn=None,
                          algo=pca, algo_options={}, interp_order=-1,
                          imlib="skimage", interpolation="biquintic",
                          transmission=None, weights=None, plot=False,
                          verbose=False, rot_options={}):
    """Nelder-Mead refinement of all disk parameters (vip_tpu
    negfd_simplex.py:124)."""
    cube = as_tensor(cube)
    disk_model = as_tensor(disk_model, cube.device, cube.dtype)
    if verbose:
        print("\nNelder-Mead minimization is running...")

    if force_params is not None:
        p_t, p_ini = [], []
        for i in range(len(p)):
            if force_params[i]:
                p_ini.append(p[i])
            else:
                p_t.append(p[i])
        p_t = tuple(p_t)
        p_ini = tuple(p_ini)
    else:
        p_t = p
        p_ini = p

    solu = minimize(chisquare_fd, p_t,
                    args=(cube, angs, disk_model, mask_fm, p_ini,
                          force_params, grid_params_list, fmerit, mu_sigma,
                          psfn, algo, algo_options, interp_order, imlib,
                          interpolation, transmission, weights, False,
                          rot_options),
                    method="Nelder-Mead", options=options)
    if verbose:
        print(solu)
    return solu


def firstguess_fd(cube, angs, disk_model, mask_fm, ini_xy=(0, 0),
                  ini_theta=0, ini_scal=1.0, ini_f=None,
                  grid_params_list=None, grid_params_labels=None,
                  fmerit="sum", mu_sigma=None, f_range=None, psfn=None,
                  algo=pca, algo_options={}, interp_order=-1,
                  imlib="skimage", interpolation="biquintic", simplex=True,
                  simplex_options=None, transmission=None, weights=None,
                  force_params=None, plot=False, verbose=True, save=False,
                  full_output=False, rot_options={}):
    """First guess of the disk model's shift, rotation, scaling and flux:
    a grid search of the flux, then an optional simplex (vip_tpu
    negfd_simplex.py:161)."""
    cube = as_tensor(cube)
    disk_model = as_tensor(disk_model, cube.device, cube.dtype)
    if cube.ndim != 3 and cube.ndim != 4:
        raise TypeError("Input cube is not 3D nor 4D")
    if ini_f is not None and not simplex:
        raise TypeError("ini_f provided and simplex set to False => no "
                        "minimization done")
    if verbose:
        start_time = time_ini()

    ini_xy = np.array(ini_xy)
    if cube.ndim == 4:
        if psfn is not None and psfn.ndim < 3:
            raise TypeError("The normalized PSF should be 3D for a 4D input "
                            "cube.")
        if disk_model.ndim < 3:
            raise TypeError("The disk model should be at least 3D for a 4D "
                            "input cube.")
        if disk_model.shape[0] != cube.shape[0] and \
                disk_model.ndim == cube.ndim - 1:
            raise TypeError("First dimension of disk_model and cube should "
                            "match.")
    else:
        if disk_model.ndim < 2:
            raise TypeError("The disk model should be at least 2D for a 3D "
                            "input cube.")
    if weights is not None and len(weights) != cube.shape[-3]:
        raise TypeError("Weights should have same length as temporal cube "
                        "axis.")
    if isinstance(mu_sigma, tuple) and len(mu_sigma) != 2:
        raise TypeError("If a tuple, mu_sigma must have 2 elements")

    extra_dims = disk_model.ndim - cube.ndim + 1
    uidx_min = None
    if extra_dims > 0:
        if grid_params_list is None:
            raise TypeError("Input grid_params_list should be provided if a "
                            "disk model grid is provided")
        if len(grid_params_list) != extra_dims:
            raise TypeError("Input grid_params_list should have same length "
                            "as the number of extra dimensions in the input "
                            "disk model grid.")
        for e in range(extra_dims):
            if len(grid_params_list[e]) != disk_model.shape[e]:
                raise TypeError("Input grid_params_list lengths and the "
                                "first dimensions of the disk model grid "
                                "should match. Not the case for dimension "
                                "{}: {} vs {}".format(
                                    e, len(grid_params_list[e]),
                                    disk_model.shape[e]))
        dim_test = disk_model.shape[:extra_dims]
        ntests = int(np.prod(dim_test))
        if ini_f is not None:
            f_range = np.array([ini_f])
        all_chi2r = np.ones(ntests)
        all_res = []
        for c in range(ntests):
            unravel_idx = np.unravel_index(c, dim_test)
            res_c = firstguess_fd_from_coord(
                ini_xy, ini_theta, ini_scal, cube, angs,
                disk_model[unravel_idx], mask_fm, fmerit=fmerit,
                mu_sigma=mu_sigma, f_range=f_range, psfn=psfn, algo=algo,
                algo_options=algo_options, interp_order=interp_order,
                imlib=imlib, interpolation=interpolation,
                transmission=transmission, weights=weights, plot=plot,
                verbose=verbose, full_output=True, save=save,
                rot_options=rot_options)
            all_res.append(res_c[0])
            all_chi2r[c] = np.nanmin(res_c[-1])
        max_chi = np.nanmax(all_chi2r)
        all_chi2r[np.where(~np.isfinite(all_chi2r))] = max_chi
        idx_min = np.argmin(all_chi2r)
        uidx_min = np.unravel_index(idx_min, dim_test)

        res_init = [grid_params_list[e][uidx_min[e]]
                    for e in range(extra_dims)]
        res_init.extend(list(all_res[idx_min]))
        x_pre = res_init[extra_dims + 0]
        y_pre = res_init[extra_dims + 1]
        theta_pre = res_init[extra_dims + 2]
        scal_pre = res_init[extra_dims + 3]
        f_pre = res_init[extra_dims + 4:]
        grid_params_pre = tuple(res_init[:extra_dims])
    elif ini_f is not None:
        x_pre, y_pre = ini_xy[0], ini_xy[1]
        theta_pre, scal_pre = ini_theta, ini_scal
        f_pre = np.atleast_1d(ini_f)
        res_init = [x_pre, y_pre, theta_pre, scal_pre] + list(f_pre)
    else:
        if verbose:
            print("\n" + SEP)
            print("Flux estimation for xy shift [{},{}], {}deg rotation and "
                  "{}x spatial scaling is running ...".format(
                      ini_xy[0], ini_xy[1], ini_theta, ini_scal))
        res_init = firstguess_fd_from_coord(
            ini_xy, ini_theta, ini_scal, cube, angs, disk_model, mask_fm,
            fmerit=fmerit, mu_sigma=mu_sigma, f_range=f_range, psfn=psfn,
            algo=algo, algo_options=algo_options, interp_order=interp_order,
            imlib=imlib, interpolation=interpolation,
            transmission=transmission, weights=weights, plot=plot,
            verbose=verbose, save=save, rot_options=rot_options)
        x_pre, y_pre = res_init[0], res_init[1]
        theta_pre, scal_pre = res_init[2], res_init[3]
        f_pre = res_init[4:]
        res_init = list(res_init)

    if verbose:
        msg = ""
        if extra_dims > 0:
            msg = ("Preliminary indices of best model in disk model grid: "
                   "{}. ".format(uidx_min))
        msg += ("Preliminary shift, rotation and scaling guess: (x, y, "
                "theta, scal) = ({:.1f}, {:.1f}, {:.1f}, {:.1f})"
                .format(x_pre, y_pre, theta_pre, scal_pre))
        print(msg)
        print("Preliminary flux guess: " +
              ", ".join("{:.1f}".format(f) for f in np.atleast_1d(f_pre)))

    res = None
    grid_params_0 = None
    if simplex:
        if verbose:
            print("Simplex Nelder-Mead minimization, running ...")
        if simplex_options is None:
            simplex_options = {"xatol": 1e-6, "fatol": 1e-6, "maxiter": 800,
                               "maxfev": 2000}
        if verbose:
            print("Initial guess: ", res_init)
        res = firstguess_fd_simplex(
            res_init, cube, angs, disk_model, mask_fm, grid_params_list,
            fmerit, mu_sigma, force_params, simplex_options, psfn, algo,
            algo_options, interp_order, imlib, interpolation, transmission,
            weights, plot, verbose, rot_options)
        if force_params is not None:
            params_0 = []
            c_free = 0
            for i in range(len(res_init)):
                if force_params[i]:
                    params_0.append(res_init[i])
                else:
                    params_0.append(res.x[c_free])
                    c_free += 1
            if extra_dims > 0:
                grid_params_0 = tuple(params_0[:extra_dims])
            x_0, y_0, theta_0, scal_0 = tuple(
                params_0[extra_dims:extra_dims + 4])
            if cube.ndim == 3:
                f_0 = params_0[extra_dims + 4]
            else:
                f_0 = tuple(params_0[extra_dims + 4:])
        else:
            if extra_dims > 0:
                grid_params_0 = tuple(res.x[:extra_dims])
            x_0, y_0 = res.x[extra_dims], res.x[extra_dims + 1]
            theta_0, scal_0 = res.x[extra_dims + 2], res.x[extra_dims + 3]
            if cube.ndim == 3:
                f_0 = res.x[extra_dims + 4]
            else:
                f_0 = res.x[extra_dims + 4:]
        if verbose:
            print("Success: {}, nit: {}, nfev: {}, chi2r: {}".format(
                res.success, res.nit, res.nfev, res.fun))
            print("message: {}".format(res.message))
    else:
        if verbose:
            print("Simplex Nelder-Mead minimization skipped.")
        if extra_dims > 0:
            grid_params_0 = grid_params_pre
        x_0, y_0, theta_0, scal_0 = x_pre, y_pre, theta_pre, scal_pre
        f_0 = f_pre[0] if cube.ndim == 3 else f_pre

    res_0 = []
    if extra_dims > 0:
        res_0.extend(list(grid_params_0))
    res_0.extend([x_0, y_0, theta_0, scal_0, f_0])

    if verbose:
        print("Optimization result: (dx, dy, dtheta, scal, f) = "
              "({:.2f}, {:.2f}, {:.2f}, {:.2f}, {})".format(
                  x_0, y_0, theta_0, scal_0, f_0))
        print("\n", SEP, "\nDONE !\n", SEP)
        timing(start_time)

    if full_output and res is not None:
        res_0.append(float(res.fun))
    return tuple(res_0)

"""Figure of merit of NEGFD, the negative fake disk optimization (port of
``vip_tpu.fm.negfd_fmerit``).

The disk model, its negative injection, the PSF subtraction (``algo``,
the port's ``pca`` by default) and the masked residuals stay on the
cube's device; each figure of merit comes back to the host as one pair of
numbers (the statistic and the count of pixels it read).
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..psfsub.pca_fullfr import pca
from .negfd_interp import interpolate_model
from .utils_negfd import cube_disk_free

__all__ = ["chisquare_fd"]


def chisquare_fd(modelParameters, cube, angs, disk_model, mask_fm,
                 initialState, force_params=None, grid_param_list=None,
                 fmerit="sum", mu_sigma=None, psfn=None, algo=pca,
                 algo_options={}, interp_order=-1, imlib="skimage",
                 interpolation="biquintic", transmission=None, weights=None,
                 debug=False, rot_options={}):
    """Reduced chi2 of the residuals after negative disk injection and PSF
    subtraction (vip_tpu negfd_fmerit.py:13).

    modelParameters: (x, y, theta, scal, flux) for 3D cubes, with optional
    leading grid parameters and per-channel fluxes for 4D cubes;
    ``force_params`` marks fixed parameters pulled from ``initialState``.
    """
    cube = as_tensor(cube)
    disk_model = as_tensor(disk_model, cube.device, cube.dtype)
    grid_ndim = disk_model.ndim - cube.ndim + 1

    if cube.ndim == 3:
        multispectral = False
        if force_params is not None:
            grid_params, df_params = _split_params(
                modelParameters, initialState, force_params, grid_ndim,
                len(force_params))
            x, y, theta, scal = tuple(df_params[:4])
            flux_tmp = df_params[-1]
        else:
            grid_params = modelParameters[:grid_ndim] if grid_ndim > 0 else []
            x, y, theta, scal = modelParameters[grid_ndim:grid_ndim + 4]
            flux_tmp = modelParameters[grid_ndim + 4:]
            if len(np.atleast_1d(flux_tmp)) == 1:
                flux_tmp = np.atleast_1d(flux_tmp)[0]
    else:
        multispectral = True
        if force_params is not None:
            flux_fix = force_params[grid_ndim + 4]
            for j in range(len(force_params) - (5 + grid_ndim)):
                if force_params[j + 5 + grid_ndim] != flux_fix:
                    raise ValueError("All fluxes need to be either free or "
                                     "fixed")
            grid_params, df_params = _split_params(
                modelParameters, initialState, force_params, grid_ndim,
                grid_ndim + 4)
            x, y, theta, scal = tuple(df_params)
            n_used = sum(1 for i in range(grid_ndim + 4)
                         if force_params[i])
            n_free = (grid_ndim + 4) - n_used
            if flux_fix:
                flux_tmp = np.asarray(initialState[n_used:])
            else:
                flux_tmp = np.asarray(modelParameters[n_free:])
        else:
            grid_params = modelParameters[:grid_ndim] if grid_ndim > 0 else []
            x = modelParameters[grid_ndim + 0]
            y = modelParameters[grid_ndim + 1]
            theta = modelParameters[grid_ndim + 2]
            scal = modelParameters[grid_ndim + 3]
            flux_tmp = np.array(modelParameters[grid_ndim + 4:])

    # temporal weights scale the injected frames once, in cube_disk_free
    # (vip_tpu also multiplies the flux by them, a per-frame vector that
    # cannot scale the model frame: ROADMAP Queue 3)
    df_params = (x, y, theta, scal, flux_tmp)

    # interpolate in the model grid, if any
    if grid_ndim > 0:
        grid_params = tuple(grid_params)
        for p in range(len(grid_param_list)):
            if grid_params[p] < grid_param_list[p][0]:
                return np.inf
            if grid_params[p] > grid_param_list[p][-1]:
                return np.inf
        disk_img = interpolate_model(grid_params, grid_param_list,
                                     disk_model, multispectral=multispectral,
                                     interp_order=interp_order)
    else:
        disk_img = disk_model.clone()

    # imlib pairing for shift vs rotation (vip_tpu negfd_fmerit.py:93-101)
    if imlib == "opencv":
        imlib_sh = imlib_rot = imlib
    elif imlib in ("skimage", "ndimage-interp"):
        imlib_sh = "ndimage-interp"
        imlib_rot = "skimage"
    elif imlib in ("vip-fft", "ndimage-fourier"):
        imlib_sh = "ndimage-fourier"
        imlib_rot = "vip-fft"
    else:
        raise TypeError("Interpolation not recognized.")

    cube_negfd = cube_disk_free(df_params, cube, angs, disk_img, psfn=None,
                                imlib=imlib_rot, interpolation=interpolation,
                                imlib_sh=imlib_sh,
                                interpolation_sh=interpolation,
                                transmission=transmission, weights=weights,
                                **rot_options)

    res = as_tensor(algo(cube=cube_negfd, angle_list=angs, **algo_options),
                    cube.device)
    # the masked nonzero residuals, as weights over the frame: no
    # compaction on the device, one host copy of (statistic, count)
    mask = torch.as_tensor(np.asarray(mask_fm.detach().cpu().numpy()
                                      if isinstance(mask_fm, torch.Tensor)
                                      else mask_fm).astype(bool),
                           device=res.device)
    keep = mask & (res != 0)
    w = keep.to(res.dtype)
    count = w.sum()
    if mu_sigma is None:
        if fmerit == "sum":
            stat = torch.sum(torch.abs(res) * w)
        elif fmerit == "stddev":
            mean = torch.sum(res * w) / count
            stat = torch.sqrt(torch.sum(((res - mean) * w) ** 2) / count) \
                * count
        else:
            raise RuntimeError("fmerit choice not recognized.")
    else:
        mu, sigma = mu_sigma[0], mu_sigma[1]
        shape = tuple(cube.shape[-2:])
        if isinstance(mu, np.ndarray) and mu.shape != shape:
            raise TypeError("If input mu is an array, it should have "
                            "same shape as cube frames")
        if isinstance(sigma, np.ndarray) and sigma.shape != shape:
            raise TypeError("If input sigma is an array, it should have "
                            "same shape as cube frames")
        mu_t = torch.as_tensor(mu, dtype=res.dtype, device=res.device)
        sig_t = torch.as_tensor(sigma, dtype=res.dtype, device=res.device)
        z = torch.where(keep, (mu_t - res) / sig_t, 0.0)
        stat = torch.sum(z ** 2)
    stat, count = (float(v) for v in torch.stack([stat, count]).cpu())
    ddf = int(count) - len(modelParameters)
    if ddf < 1:
        raise ValueError("Not enough pixels at the intersection of input "
                         "binary mask and area where the algorithm is run. "
                         "Check mask_fm and algo_params.")
    if count < 10:
        print("WARNING: less than 10 pixels in the optimization area "
              "(intersection of input binary mask and where the algorithm "
              "is run). You may want to double-check mask_fm and "
              "algo_params.")
    return stat / ddf


def _split_params(modelParameters, initialState, force_params, grid_ndim,
                  nparams):
    """Merge free (modelParameters) and fixed (initialState) parameters
    following the force_params flags (vip_tpu negfd_fmerit.py:151)."""
    grid_params, df_params = [], []
    c_free = 0
    c_forced = 0
    for i in range(nparams):
        if force_params[i]:
            val = initialState[c_forced]
            c_forced += 1
        else:
            val = modelParameters[c_free]
            c_free += 1
        (grid_params if i < grid_ndim else df_params).append(val)
    return grid_params, df_params

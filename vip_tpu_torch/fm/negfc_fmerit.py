"""NEGFC figure of merit and annulus noise statistics (port of
``vip_tpu.fm.negfc_fmerit``).

``chisquare`` injects the negative companion into the cube on the cube's
device (``ops.negfc_model._inject_negfc``: the 'ndimage-fourier' stamps
of all frames from one batched FFT, placed by one indexed subtract; with
a radial-gradient transmission the host injector
``fm.cube_inject_companions``), runs the PSF-subtraction algo
(``pca_annulus`` by default) on that device, reads the aperture values
on the host and computes the merit there. ``get_mu_and_sigma`` reduces
the cube (with the companion removed when its flux is given) and takes
the statistics of an annular wedge. The algos' frames come back to the
host as float64 numpy. The high-pass filter of ``algo_options``
(``hp_filter``, ``hp_kernel``) filters the cube on its device before the
reduction (``var.filters.cube_filter_highpass``).

A 4-d (channels, frames, y, x) cube takes one flux a channel, or one for
all with ``bin_spec``; the companion is removed channel by channel with
each channel's PSF, and the algo reduces the 4-d cube (``pca_annulus``
collapses the channels with ``collapse_ifs``, 'absmean' by default).
In ``get_mu_and_sigma`` the multi-flux companion sits at (r_guess,
theta_guess) in every channel; vip_tpu puts r_guess in its theta there
(negfc_fmerit.py:275; ROADMAP.md Queue 3).
"""

import numpy as np
import torch
from scipy.interpolate import interp1d

from ..config.device import as_tensor
from ..ops.negfc_model import _inject_negfc
from ..preproc.cosmetics import cube_crop_frames, frame_crop
from ..psfsub.nmf_local import nmf_annular
from ..psfsub.pca_fullfr import pca
from ..psfsub.pca_local import pca_annular
from ..psfsub.utils_pca import pca_annulus
from ..var.coords import frame_center
from ..var.filters import cube_filter_highpass
from ..var.shapes import disk_coords, get_annular_wedge, get_annulus_segments
from .fakecomp import (_extend_transmission, _host, cube_inject_companions,
                       cube_planet_free)

__all__ = ["chisquare", "get_values_optimize", "get_mu_and_sigma", "hessian"]


def _check_cube(cube):
    if cube.ndim not in (3, 4):
        raise ValueError("`cube` must be a 3D or 4D numpy array")


def _shift_imlibs(imlib):
    """(shift imlib, rotation imlib) of a NEGFC ``imlib`` (vip_tpu
    negfc_fmerit.py:48-58)."""
    if imlib == "opencv":
        return imlib, imlib
    if imlib in ("skimage", "ndimage-interp"):
        return "ndimage-interp", "skimage"
    if imlib in ("vip-fft", "ndimage-fourier"):
        return "ndimage-fourier", "vip-fft"
    raise TypeError("Interpolation not recognized.")


def _inject_negative(cube, psfn, angs, r, theta, flux, imlib_sh,
                     interpolation, transmission, radial_gradient):
    """The cube with the companion (r, theta) of ``flux`` (a scalar or one
    value a frame; for a 4-d cube also one a channel, or a (channels,
    frames) array) subtracted. The 'ndimage-fourier' injection runs on the
    cube's device, channel by channel for a 4-d cube without a
    transmission; the others (a transmission of a 4-d cube, a
    radial-gradient transmission, the interpolating imlibs, which raise
    until slice 8) take the host injector."""
    if cube.ndim == 4 and imlib_sh == "ndimage-fourier" \
            and transmission is None:
        psf = _host(psfn)
        # the host injector's reading of a 4-d flux: a scalar for all, a
        # vector one a channel (its first entries), an array one a
        # (channel, frame)
        nch, n = cube.shape[:2]
        fl = np.asarray(flux, float)
        if fl.ndim == 1:
            fl = np.tile(fl[:, None], (1, n))[:nch]
        fl = np.broadcast_to(fl, (nch, n))
        return torch.stack([_inject_negfc(cube[ch], psf[ch], angs, r, theta,
                                          fl[ch])
                            for ch in range(cube.shape[0])])
    if imlib_sh == "ndimage-fourier" and cube.ndim == 3 and not (
            transmission is not None and radial_gradient):
        psf = _host(psfn)
        if transmission is not None:
            table = _extend_transmission(np.asarray(transmission, float),
                                         cube.shape[-1])
            psf = interp1d(table[0], table[1])(r) * psf
        return _inject_negfc(cube, psf, angs, r, theta, flux)
    return cube_inject_companions(
        cube, psfn, angs, flevel=-flux, rad_dists=[r],
        n_branches=1, theta=theta, imlib=imlib_sh,
        interpolation=interpolation, transmission=transmission,
        radial_gradient=radial_gradient, verbose=False)


def chisquare(modelParameters, cube, angs, psfs_norm, fwhm, annulus_width,
              aperture_radius, initialState, ncomp, cube_ref=None,
              svd_mode="lapack", scaling=None, fmerit="sum",
              collapse="median", algo=pca_annulus, delta_rot=1,
              imlib="vip-fft", interpolation="lanczos4", algo_options={},
              transmission=None, radial_gradient=False, mu_sigma=(0, 1),
              weights=None, force_rPA=False, ndet=None, bin_spec=False,
              debug=False):
    """Reduced χ² of the residuals after the negative injection of the
    companion (r, theta, flux) (vip_tpu negfc_fmerit.py:24; same
    parameters): merit 'sum', 'stddev' or 'hessian' with ``mu_sigma``
    None, else the Gaussian χ² of (mu, sigma). A 4-d cube takes (r,
    theta, f_1..f_z), or (r, theta, f) with ``bin_spec``."""
    _check_cube(cube)
    if cube.ndim == 3 or bin_spec:
        if force_rPA:
            r, theta = initialState
            flux_tmp = modelParameters[0]
        else:
            r, theta, flux_tmp = modelParameters
    elif force_rPA:
        r, theta = initialState
        flux_tmp = np.array(modelParameters)
    else:
        r, theta = modelParameters[0], modelParameters[1]
        flux_tmp = np.array(modelParameters[2:])
    imlib_sh, imlib_rot = _shift_imlibs(imlib)

    norm_weights = None
    flux = flux_tmp
    if weights is not None:
        flux = flux_tmp * np.asarray(weights) if np.isscalar(flux_tmp) \
            else np.outer(flux_tmp, weights)
        norm_weights = weights / np.sum(weights)
    cube_negfc = _inject_negative(as_tensor(cube), psfs_norm, _host(angs),
                                  r, theta, flux, imlib_sh, interpolation,
                                  transmission, radial_gradient)

    full_output = (debug and collapse) or (fmerit == "hessian")
    res = get_values_optimize(
        cube_negfc, angs, ncomp, annulus_width, aperture_radius, fwhm,
        initialState[0], initialState[1], cube_ref=cube_ref,
        svd_mode=svd_mode, scaling=scaling, algo=algo, delta_rot=delta_rot,
        collapse=collapse, algo_options=algo_options, weights=norm_weights,
        imlib=imlib_rot, interpolation=interpolation,
        full_output=full_output)
    if full_output:
        values, frpca = res
    else:
        values = res

    if mu_sigma is None:
        if fmerit == "sum":
            ddf = values.size - len(np.atleast_1d(modelParameters))
            chi = np.nansum(np.abs(values)) / ddf
        elif fmerit == "stddev":
            values = values[values != 0]
            ddf = values.size - len(np.atleast_1d(modelParameters))
            chi = np.nanstd(values) * values.size / ddf
        elif fmerit == "hessian":
            if ndet is None:
                ndet = int(round(max(min(fwhm / 2, r), 2)))
            elif not isinstance(ndet, int):
                raise TypeError("If provided, ndet should be an integer")
            ny, nx = frpca.shape[-2:]
            cy, cx = frame_center(frpca)
            yi = cy + r * np.sin(np.deg2rad(theta))
            xi = cx + r * np.cos(np.deg2rad(theta))
            if ndet % 2:
                yround, xround = int(np.round(yi)), int(np.round(xi))
            else:
                yround, xround = int(np.ceil(yi)), int(np.ceil(xi))
            crop_sz = ndet + 4
            if crop_sz / 2 > np.amin([yround, xround, ny - yround,
                                      nx - xround]):
                raise ValueError("Test location too close from image edge "
                                 "for Hessian calculation. Consider larger "
                                 "input images.")
            subim = _host(frame_crop(frpca, crop_sz, xy=(xround, yround),
                                     force=True, verbose=False))
            H = hessian(subim)
            dets = np.zeros([ndet, ndet])
            for i in range(ndet):
                for j in range(ndet):
                    dets[i, j] = np.linalg.det(H[:, :, 2 + i, 2 + j])
            chi = np.sum(np.abs(dets))
        else:
            raise RuntimeError("fmerit choice not recognized.")
    else:
        mu, sigma = mu_sigma[0], mu_sigma[1]
        ddf = values.size - len(np.atleast_1d(modelParameters))
        chi = np.sum(np.power(mu - values, 2) / sigma**2) / ddf
    return chi


def _annular_crop(cube, radius_int, asize):
    """The cube cropped to the annuli's odd box, and the pad that restores
    the frame size (vip_tpu negfc_fmerit.py:174-181)."""
    crop_sz = int(2 * np.ceil(radius_int + asize + 1))
    crop_sz += 1 - crop_sz % 2
    if crop_sz < min(cube.shape[-2], cube.shape[-1]):
        return (cube_crop_frames(cube, crop_sz, verbose=False),
                int((cube.shape[-2] - crop_sz) / 2))
    return cube, 0


def get_values_optimize(cube, angs, ncomp, annulus_width, aperture_radius,
                        fwhm, r_guess, theta_guess, cube_ref=None,
                        svd_mode="lapack", scaling=None, algo=pca_annulus,
                        delta_rot=1, imlib="vip-fft",
                        interpolation="lanczos4", collapse="median",
                        algo_options={}, weights=None, full_output=False):
    """Host float64 pixel values in the NEGFC aperture of the algo's
    reduction of ``cube``, run on the cube's device (vip_tpu
    negfc_fmerit.py:134; same parameters); with ``full_output`` also the
    reduced frame."""
    _check_cube(cube)
    ceny_fr, cenx_fr = frame_center(cube)
    posy = r_guess * np.sin(np.deg2rad(theta_guess)) + ceny_fr
    posx = r_guess * np.cos(np.deg2rad(theta_guess)) + cenx_fr
    halfw = max(aperture_radius * fwhm, annulus_width / 2)
    if r_guess > cenx_fr - halfw:
        raise RuntimeError(
            "The annulus and/or the circular aperture used by the NegFC "
            "falls outside the FOV. Try increasing the size of your frames "
            "or decreasing the annulus or aperture size. "
            f"r_guess: {r_guess:.1f}px; half xy dim: {cenx_fr:.1f}px")

    # user-supplied algo_options win over this function's own defaults;
    # whatever is not consumed here flows through to the algo verbatim
    opts = dict(algo_options)

    def _pull(**defaults):
        return {k: opts.pop(k, v) for k, v in defaults.items()}

    base = _pull(ncomp=ncomp, svd_mode=svd_mode, scaling=scaling,
                 imlib=imlib, interpolation=interpolation,
                 collapse=collapse, collapse_ifs="absmean", nproc=1,
                 verbose=False)
    collapse = base["collapse"]      # downstream shape logic keys on it

    if algo is pca_annulus:
        res = pca_annulus(cube, angs, base["ncomp"], annulus_width,
                          r_guess, cube_ref, base["svd_mode"],
                          base["scaling"], imlib=base["imlib"],
                          interpolation=base["interpolation"],
                          collapse=base["collapse"],
                          collapse_ifs=base["collapse_ifs"],
                          weights=weights, **opts)
    elif algo is pca_annular or algo is nmf_annular:
        ann = _pull(tol=1e-1, min_frames_lib=2, max_frames_lib=200,
                    radius_int=max(1, int(np.floor(r_guess
                                                   - annulus_width / 2))),
                    asize=annulus_width, delta_rot=delta_rot)
        crop_cube, pad = _annular_crop(cube, ann["radius_int"], ann["asize"])
        call = dict(cube=crop_cube, angle_list=angs, cube_ref=cube_ref,
                    fwhm=fwhm, radius_int=ann["radius_int"],
                    delta_rot=ann["delta_rot"], ncomp=base["ncomp"],
                    scaling=base["scaling"], imlib=base["imlib"],
                    interpolation=base["interpolation"],
                    collapse=base["collapse"], weights=weights,
                    nproc=base["nproc"],
                    min_frames_lib=ann["min_frames_lib"],
                    max_frames_lib=ann["max_frames_lib"],
                    full_output=False, verbose=base["verbose"])
        if algo is pca_annular:
            call.update(asize=ann["asize"], svd_mode=base["svd_mode"],
                        collapse_ifs=base["collapse_ifs"], tol=ann["tol"])
        else:
            # vip_tpu's quirk, kept: the nmf_annular branch passes the raw
            # annulus_width, not the (possibly overridden) asize
            call.update(asize=annulus_width)
        res = np.pad(_host(algo(**call, **opts)), pad, mode="constant",
                     constant_values=0)
    elif algo is pca:
        extra = _pull(scale_list=None, ifs_collapse_range="all",
                      mask_rdi=None, delta_rot=delta_rot, source_xy=None)
        res = pca(cube=cube, angle_list=angs, cube_ref=cube_ref,
                  fwhm=fwhm, weights=weights, **base, **extra, **opts)
    else:
        res = algo(cube=cube, angle_list=angs, **algo_options)
    res = _host(res)

    frame_shape = res.shape[-2:] if collapse is None else res.shape
    yy, xx = disk_coords((posy, posx), radius=aperture_radius * fwhm,
                         shape=frame_shape)
    if algo is pca_annulus:
        # the aperture pixels inside the annulus, in the aperture's order
        yy_a, xx_a = get_annulus_segments(
            (res.shape[-1], res.shape[-1]), r_guess - annulus_width / 2,
            annulus_width, nsegm=1)[0]
        ann = set(zip(yy_a.tolist(), xx_a.tolist()))
        keep = [i for i, p in enumerate(zip(yy.tolist(), xx.tolist()))
                if p in ann]
        yy, xx = yy[keep].astype(int), xx[keep].astype(int)

    if collapse is None:
        values = res[:, yy, xx].ravel()
    else:
        values = res[yy, xx].ravel()
    if full_output and collapse is not None:
        return values, res
    return values


def get_mu_and_sigma(cube, angs, ncomp, annulus_width, aperture_radius, fwhm,
                     r_guess, theta_guess, f_guess=None, psfn=None,
                     cube_ref=None, wedge=None, svd_mode="lapack",
                     scaling=None, algo=pca_annulus, delta_rot=1,
                     imlib="vip-fft", interpolation="lanczos4",
                     collapse="median", weights=None, algo_options={},
                     bin_spec=False, verbose=False):
    """Mean and standard deviation of the residual pixels in an annular
    wedge at the companion's radius, excluding the companion (vip_tpu
    negfc_fmerit.py:247; same parameters). With ``f_guess`` and ``psfn``
    the companion is removed first and the wedge is the full annulus of
    the reduction plus that of the reduction with the angles negated. A
    4-d cube takes one flux a channel, the companion at (r_guess,
    theta_guess) in each (vip_tpu puts r_guess in theta,
    negfc_fmerit.py:275)."""
    _check_cube(cube)
    angs = _host(angs)
    centy_fr, cenx_fr = frame_center(cube)
    halfw = max(aperture_radius * fwhm, annulus_width / 2)
    if r_guess > cenx_fr - halfw:
        raise RuntimeError(
            "The annulus and/or the circular aperture used by the NegFC "
            "falls outside the FOV.")
    if r_guess < fwhm:
        raise ValueError("r_guess should be greater than fwhm.")

    if f_guess is not None and psfn is not None:
        if np.isscalar(f_guess):
            planet_parameter = (r_guess, theta_guess, f_guess)
        elif len(f_guess) == 1:
            planet_parameter = (r_guess, theta_guess, f_guess[0])
        else:
            # the multi-flux (4-d) branch, at theta_guess (vip_tpu puts
            # r_guess there: ROADMAP.md Queue 3)
            planet_parameter = np.array([[r_guess] * len(f_guess),
                                         [theta_guess] * len(f_guess),
                                         f_guess])
        array = cube_planet_free(planet_parameter, cube, angs, psfn,
                                 imlib=imlib, interpolation=interpolation)
    else:
        array = cube   # the reductions below leave their input as it is

    opts = dict(algo_options)

    def _pull(**defaults):
        return {k: opts.pop(k, v) for k, v in defaults.items()}

    base = _pull(ncomp=ncomp, svd_mode=svd_mode, scaling=scaling,
                 imlib=imlib, interpolation=interpolation,
                 collapse=collapse,
                 radius_int=max(int(np.floor(r_guess - annulus_width / 2)),
                                0))
    radius_int = base["radius_int"]

    hp = _pull(hp_filter=None, hp_kernel=None)
    if hp["hp_filter"] is not None:
        mode = hp["hp_filter"]
        size_kw = ("median_size" if "median" in mode
                   else "fwhm_size" if "gauss" in mode else "kernel_size")
        array = cube_filter_highpass(array, mode=mode,
                                     **{size_kw: hp["hp_kernel"]})

    # the inverse-angle reduction (speckle-noise realization with the
    # companion removed) is needed whenever a planet was subtracted
    need_inv = f_guess is not None and psfn is not None
    pca_res_inv = None
    if algo is pca_annulus:
        def _annulus(a_list):
            return _host(pca_annulus(
                array, a_list, base["ncomp"], annulus_width, r_guess,
                cube_ref, base["svd_mode"], base["scaling"],
                imlib=base["imlib"], interpolation=base["interpolation"],
                collapse=base["collapse"], weights=weights, **opts))
        pca_res = _annulus(angs)
        if need_inv:
            pca_res_inv = _annulus(-angs)
    elif algo is pca_annular or algo is nmf_annular:
        ann = _pull(tol=1e-1, min_frames_lib=2, max_frames_lib=200,
                    radius_int=max(1, int(np.floor(r_guess
                                                   - annulus_width / 2))),
                    asize=annulus_width, delta_rot=delta_rot,
                    verbose=verbose)
        radius_int = ann["radius_int"]
        crop_cube, pad = _annular_crop(array, ann["radius_int"],
                                       ann["asize"])
        common = dict(cube_ref=cube_ref, radius_int=ann["radius_int"],
                      fwhm=fwhm, asize=annulus_width,
                      delta_rot=ann["delta_rot"], ncomp=base["ncomp"],
                      scaling=base["scaling"], imlib=base["imlib"],
                      interpolation=base["interpolation"],
                      collapse=base["collapse"], tol=ann["tol"],
                      min_frames_lib=ann["min_frames_lib"],
                      max_frames_lib=ann["max_frames_lib"],
                      full_output=False, verbose=False, weights=weights,
                      **opts)
        if algo is pca_annular:
            common["svd_mode"] = base["svd_mode"]

        def _annular(a_list):
            return np.pad(_host(algo(cube=crop_cube, angle_list=a_list,
                                     **common)),
                          pad, mode="constant", constant_values=0)
        pca_res = _annular(angs)
        if need_inv:
            pca_res_inv = _annular(-angs)
    elif algo is pca:
        extra = _pull(scale_list=None, ifs_collapse_range="all", nproc=1,
                      source_xy=None)
        common = dict(cube_ref=cube_ref, delta_rot=delta_rot,
                      weights=weights, verbose=False,
                      **{k: v for k, v in base.items()
                         if k != "radius_int"},
                      **extra, **opts)
        pca_res = _host(pca(cube=array, angle_list=angs, **common))
        if need_inv:
            pca_res_inv = _host(pca(cube=array, angle_list=-angs, **common))
    else:
        pca_res = _host(algo(cube=array, angle_list=angs, **algo_options))
        if need_inv:
            pca_res_inv = _host(algo(cube=array, angle_list=-angs,
                                     **algo_options))

    if need_inv:
        if wedge is None:
            wedge = (0, 360)
    elif wedge is None:
        delta_theta = min(np.amax(angs) - np.amin(angs), 120)
        theta_ini = (theta_guess + delta_theta) % 360
        wedge = (theta_ini, theta_ini + (360 - 2 * delta_theta))
    if len(wedge) != 2:
        raise TypeError("Wedge should have exactly 2 values")
    if wedge[0] > wedge[1]:
        print("2nd value of wedge smaller than first one => +360")
        wedge = (wedge[0], wedge[1] + 360)

    width = min(annulus_width, 2 * fwhm)
    yy, xx = get_annular_wedge(pca_res.shape, inner_radius=radius_int,
                               width=width, wedge=wedge)
    if need_inv:
        yyi, xxi = get_annular_wedge(pca_res_inv.shape,
                                     inner_radius=radius_int, width=width)
        all_res = np.concatenate((pca_res[yy, xx], pca_res_inv[yyi, xxi]))
        npx = len(yy) + len(yyi)
    else:
        all_res = pca_res[yy, xx]
        npx = len(yy)
    mu = np.nanmean(all_res)
    all_res = all_res - mu
    area = np.pi * (fwhm / 2) ** 2
    ddof = min(int(npx * (1.0 - (1.0 / area))), npx - 1)
    sigma = np.nanstd(all_res, ddof=ddof)
    return mu, sigma


def hessian(array):
    """Hessian matrix of a frame by finite differences (vip_tpu
    negfc_fmerit.py:406): shape (2, 2) + frame shape."""
    array = _host(array) if isinstance(array, torch.Tensor) else array
    grad = np.gradient(array)
    hess = np.empty((array.ndim, array.ndim) + array.shape,
                    dtype=array.dtype)
    for k, grad_k in enumerate(grad):
        for m, grad_km in enumerate(np.gradient(grad_k)):
            hess[k, m, :, :] = grad_km
    return hess

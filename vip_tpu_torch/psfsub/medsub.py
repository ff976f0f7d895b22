"""Median ADI / RDI subtraction for 3-d cubes (port of
``vip_tpu.psfsub.medsub``, [MAR06]).

Full-frame ADI subtracts the per-pixel median of the cube (``numpy.median``
semantics: the two middle values averaged, any NaN propagates): CUDA
kernel H1 on the card, its plain version on the CPU. The 'annular' mode
gives each frame of each annulus its own median reference over its
PA-selected library (``_find_indices_adi``), gathered into a
(library, frames, pixels) tensor padded with NaN and reduced by the
NaN-ignoring median along the library axis (H1 on the card) — never the
(n, n, p) masked tensor of vip_tpu. The cube is then derotated (the exact
route of ``ops.shear.rotate_exact``, or fft-small) and collapsed.

A 4-d (channels, frames, y, x) cube with ``scale_list`` (ADI+mSDI) first
gets a median subtraction in the spectral dimension: the channels of all
frames rescaled in one batched zoom a channel, each channel minus the
median of its channels ('fullfr') or of its SDI library of channels
('annular', all libraries of an annulus padded with NaN and reduced in
one median), rescaled back and collapsed. The channel medians of all
frames take one median call, (z, n, y, x) viewed as (z, n·y, x): one H1
launch for the cube, not one a frame. The channel-collapsed frames then
go through the median ADI stage (unless ``sdi_only``).
"""

from dataclasses import dataclass
from enum import Enum
from typing import List, Union

import numpy as np
import torch

from ..config import Collapse, Imlib, Interpolation, time_ini, timing
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..ops.median import nanmedian_axis0, nanmedian_plain
from ..preproc import subsampling
from ..preproc.derotation import (_define_annuli, _find_indices_adi,
                                  cube_derotate)
from ..preproc.parangles import check_pa_vector
from ..preproc.subsampling import cube_collapse
from ..var.shapes import get_annulus_segments, mask_circle

__all__ = ["median_sub", "MEDIAN_SUB_Params"]

# device bytes of one (library, frames, pixels) block of the annular
# median; a tenth of an 80 GB card
_LIB_BLOCK_BYTES = 8 << 30


@dataclass
class MEDIAN_SUB_Params:
    """Parameters of ``median_sub`` (vip_tpu medsub.py:33). Arrays may be
    numpy arrays or tensors."""

    cube: object = None
    angle_list: object = None
    scale_list: object = None
    flux_sc_list: object = None
    fwhm: float = 4
    radius_int: int = 0
    asize: int = 4
    delta_rot: int = 1
    delta_sep: Union[float, tuple] = (0.1, 1)
    mode: str = "fullfr"
    nframes: int = 4
    sdi_only: bool = False
    imlib: Enum = Imlib.VIPFFT
    interpolation: Enum = Interpolation.LANCZOS4
    collapse: Enum = Collapse.MEDIAN
    cube_ref: object = None
    collapse_ref: str = "median"
    nproc: int = 1
    full_output: bool = False
    verbose: bool = True


def _value(v):
    return v.value if isinstance(v, Enum) else v


def _median0(arr, propagate):
    """Median along axis 0: H1 where its gate holds, the plain version
    otherwise (CPU, float64, more than 3600 frames). The gate is read
    from ``preproc.subsampling``, the one place a plain-route check
    turns it off for every median of the port's collapses."""
    if subsampling.nanmedian_supported(arr, 0):
        return nanmedian_axis0(arr.contiguous(), propagate=propagate)
    return nanmedian_plain(arr, 0, propagate=propagate)


def median_sub(*all_args: List, **all_kwargs: dict):
    """(Smart) median-ADI / median-RDI of a 3-d cube, or ADI+mSDI median
    subtraction of a 4-d cube (vip_tpu medsub.py:69): same parameters
    (``MEDIAN_SUB_Params``, extra keywords are the derotation's
    ``rot_options``) and return values — the final
    frame, or (cube_out, cube_der, frame) with ``full_output`` — as
    tensors on the cube's device."""
    algo_params, rot_options = resolve_algo_params(
        MEDIAN_SUB_Params, all_args, all_kwargs)
    p = algo_params
    if p.radius_int and len(rot_options) == 0:
        rot_options["mask_val"] = 0
        rot_options["ker"] = 1
        rot_options["interp_zeros"] = True

    array = as_tensor(p.cube)
    if array.ndim not in (3, 4):
        raise TypeError("Input array is not a 3d or 4d array")
    array = array.clone()
    start_time = time_ini() if p.verbose else None
    if array.ndim == 4:
        return _median_sub_4d(array, p, start_time, rot_options)

    angle_list = check_pa_vector(p.angle_list)
    n, y, x = array.shape
    if n != angle_list.shape[0]:
        raise TypeError("Input vector or parallactic angles has wrong length")

    ref_frame = None
    if p.cube_ref is not None:
        cube_ref = as_tensor(p.cube_ref, array.device, array.dtype)
        if cube_ref.shape[-1] != x or cube_ref.shape[-2] != y:
            raise TypeError("Reference cube shape should have same xy "
                            "dimensions as science cube")
        if "median" in p.collapse_ref:
            ref_frame = _median0(cube_ref, propagate=True)
        elif "mean" in p.collapse_ref:
            ref_frame = cube_ref.mean(dim=0)
        else:
            ref_frame = cube_collapse(cube_ref, mode=p.collapse_ref)
    else:
        array -= _median0(array, propagate=True)

    if p.mode == "fullfr":
        cube_out = array
        if ref_frame is not None:
            if "sc" in p.collapse_ref:
                if len(p.collapse_ref) > 9:
                    idx_rin = p.collapse_ref.index("n") + 1
                    idx_rout = p.collapse_ref.index("-")
                    rin = int(p.collapse_ref[idx_rin:idx_rout])
                    rout = int(p.collapse_ref[idx_rout + 1:])
                else:
                    rin = 0
                    rout = y // 2 - 1
                mask_ref = mask_circle(ref_frame, rin, fillwith=np.nan)
                mask_ref = mask_circle(mask_ref, rout, fillwith=np.nan,
                                       mode="out")
                mask_sci = mask_circle(array, rin, fillwith=np.nan)
                mask_sci = mask_circle(mask_sci, rout, fillwith=np.nan,
                                       mode="out")
                scal_fac = (torch.nansum(mask_sci, dim=(1, 2))
                            / torch.nansum(mask_ref))
                array -= scal_fac[:, None, None] * ref_frame
            else:
                array -= ref_frame
        if p.verbose:
            print("Median psf reference subtracted")

    elif p.mode == "annular":
        cube_out = torch.zeros_like(array)
        n_annuli = int((y / 2 - p.radius_int) / p.asize)
        if p.verbose:
            print(f"N annuli = {n_annuli}, FWHM = {p.fwhm}")
        if p.cube_ref is None and p.nframes is not None \
                and p.nframes % 2 != 0:
            raise TypeError("`nframes` argument must be even value")
        for ann in range(n_annuli):
            if p.cube_ref is None:
                mres, yy, xx, _ = _median_subt_ann_adi(
                    array, ann, angle_list, n_annuli, p.fwhm, p.radius_int,
                    p.asize, p.delta_rot, p.nframes)
            else:
                mres, yy, xx = _median_subt_ann_rdi(
                    array, ref_frame, p.collapse_ref, ann, p.radius_int,
                    p.asize)
            # a later annulus overwrites an earlier one where they meet
            cube_out[:, yy, xx] = mres
        if p.verbose:
            print("Optimized median psf reference subtracted")
    else:
        raise RuntimeError("Mode not recognized")

    cube_der = cube_derotate(cube_out, angle_list, nproc=p.nproc,
                             imlib=_value(p.imlib),
                             interpolation=_value(p.interpolation),
                             **rot_options)
    if p.radius_int:
        cube_out = mask_circle(cube_out, p.radius_int)
        cube_der = mask_circle(cube_der, p.radius_int)
    frame = cube_collapse(cube_der, mode=_value(p.collapse))

    if p.verbose:
        print("Done derotating and combining")
        timing(start_time)
    if p.full_output:
        return cube_out, cube_der, frame
    return frame


def _library_medians(matrix, libs):
    """residual[f] = matrix[f] − nanmedian(matrix[libs[f]], axis=0) for
    (n, p) ``matrix`` and host index arrays ``libs``: libraries padded with
    NaN to the longest, as (L, F, p) blocks of F frames, reduced along L."""
    n, npx = matrix.shape
    L = max(len(lib) for lib in libs)
    out = torch.empty_like(matrix)
    if L == 0:
        return out.fill_(torch.nan)
    padded = np.full((n, L), n, dtype=np.int64)    # row n is all NaN
    for f, lib in enumerate(libs):
        padded[f, :len(lib)] = lib
    ext = torch.cat([matrix, matrix.new_full((1, npx), torch.nan)])
    idx = torch.as_tensor(padded.T, device=matrix.device)       # (L, n)
    step = max(1, int(_LIB_BLOCK_BYTES
                      // max(L * npx * matrix.element_size(), 1)))
    for f0 in range(0, n, step):
        block = ext[idx[:, f0:f0 + step]]                       # (L, F, p)
        out[f0:f0 + step] = (matrix[f0:f0 + step]
                             - _median0(block, propagate=False))
    return out


def _median_subt_ann_adi(array, ann, angle_list, n_annuli, fwhm, radius_int,
                         annulus_width, delta_rot, nframes):
    """Smart median subtraction in one annulus (vip_tpu medsub.py:333):
    each frame minus the NaN-ignoring median of its PA-selected library
    (all frames when the PA threshold is 0). Returns (residuals (n, p),
    yy, xx, pa_thr)."""
    pa_thr, inner_radius, _ = _define_annuli(angle_list, ann, n_annuli, fwhm,
                                             radius_int, annulus_width,
                                             delta_rot, 1, False)
    yy, xx = get_annulus_segments(tuple(array.shape[-2:]), inner_radius,
                                  annulus_width)[0]
    matrix = array[:, torch.as_tensor(yy, device=array.device),
                   torch.as_tensor(xx, device=array.device)]
    if pa_thr != 0:
        libs = [_find_indices_adi(angle_list, frame, pa_thr, nframes)
                for frame in range(array.shape[0])]
        res = _library_medians(matrix, libs)
    else:
        res = matrix - _median0(matrix[:, None, :], propagate=False)[0]
    return res, yy, xx, pa_thr


def _median_subt_ann_rdi(array, frame_ref, collapse_ref, ann, radius_int,
                         annulus_width):
    """RDI median subtraction in one annulus (vip_tpu medsub.py:359)."""
    inner_radius = radius_int + ann * annulus_width
    yy, xx = get_annulus_segments(tuple(array.shape[-2:]), inner_radius,
                                  annulus_width)[0]
    ty = torch.as_tensor(yy, device=array.device)
    tx = torch.as_tensor(xx, device=array.device)
    matrix_ref = frame_ref[ty, tx]
    matrix = array[:, ty, tx]
    if "sc" in collapse_ref:
        scal = torch.nansum(matrix, dim=1) / torch.nansum(matrix_ref)
        return matrix - scal[:, None] * matrix_ref[None, :], yy, xx
    return matrix - matrix_ref[None, :], yy, xx


def _median_sub_4d(array, p, start_time, rot_options):
    """ADI+mSDI median subtraction (vip_tpu medsub.py:192): the spectral
    median subtraction of every frame (:func:`_median_subt_fr_sdi`, all
    frames at once), then, unless ``sdi_only``, median-ADI of the
    channel-collapsed frames."""
    from ..preproc.rescaling import _host_vec

    z, n, y_in, x_in = array.shape
    angle_list = check_pa_vector(p.angle_list)
    if p.scale_list is None:
        raise ValueError("Scaling factors vector must be provided")
    scale_list = _host_vec(p.scale_list)
    if scale_list.ndim > 1:
        raise ValueError("Scaling factors vector is not 1d")
    if not scale_list.shape[0] == z:
        raise ValueError("Scaling factors vector has wrong length")
    flux_sc_list = p.flux_sc_list
    if flux_sc_list is not None:
        flux_sc_list = _host_vec(flux_sc_list)
        if flux_sc_list.ndim > 1:
            raise ValueError("Scaling factors vector is not 1d")
        if not flux_sc_list.shape[0] == z:
            raise ValueError("Scaling factors vector has wrong length")
    fwhm = int(np.round(np.mean(p.fwhm)))
    n_annuli = int((y_in / 2 - p.radius_int) / p.asize)
    if p.nframes is not None and p.nframes % 2 != 0:
        raise TypeError("`nframes` argument must be even value")
    if p.verbose:
        print(f"{z} spectral channels per IFS frame")
        print("First median subtraction exploiting spectral variability")
        if p.mode == "annular":
            print(f"N annuli = {n_annuli}, mean FWHM = {fwhm:.3f}")

    residuals_cube_channels = _median_subt_fr_sdi(
        array, None, scale_list, flux_sc_list, n_annuli, fwhm, p.radius_int,
        p.asize, p.delta_sep, p.nframes, p.imlib, p.interpolation,
        p.collapse, p.mode)
    if p.verbose:
        if start_time is not None:
            timing(start_time)
        print(f"{n} ADI frames")
        print("Median subtraction in the ADI fashion")

    if p.sdi_only:
        cube_out = residuals_cube_channels
    elif p.mode == "fullfr":
        cube_out = residuals_cube_channels - _median0(
            residuals_cube_channels, propagate=False)
    elif p.mode == "annular":
        cube_out = torch.full_like(residuals_cube_channels, torch.nan)
        for ann in range(n_annuli):
            mres, yy, xx, _ = _median_subt_ann_adi(
                residuals_cube_channels, ann, angle_list, n_annuli, fwhm,
                p.radius_int, p.asize, p.delta_rot, p.nframes)
            cube_out[:, yy, xx] = mres
    else:
        raise RuntimeError("Mode not recognized")

    cube_der = cube_derotate(cube_out, angle_list, imlib=_value(p.imlib),
                             interpolation=_value(p.interpolation),
                             nproc=p.nproc, **rot_options)
    if p.radius_int:
        cube_der = mask_circle(cube_der, p.radius_int)
    frame = cube_collapse(cube_der, mode=_value(p.collapse))
    if p.verbose:
        print("Done derotating and combining")
        if start_time is not None:
            timing(start_time)
    if p.full_output:
        return cube_out, cube_der, frame
    return frame


def _median_subt_fr_sdi(array, fr, scal, flux_scal, n_annuli, fwhm,
                        radius_int, annulus_width, delta_sep, nframes, imlib,
                        interpolation, collapse, mode):
    """Spectral median subtraction of the temporal frames ``fr`` (indices,
    or None for all) of a (z, n, y, x) cube (vip_tpu medsub.py:276, one
    frame there). Returns the (len(fr), y, x) frames: the residual
    channels rescaled back and collapsed."""
    from ..preproc.rescaling import (_find_indices_sdi, _host_vec, _scwave,
                                     check_scal_vector)

    array = as_tensor(array)
    if fr is not None:
        array = array[:, fr]
    z, N, y_in, x_in = array.shape
    scale_list = check_scal_vector(scal)
    imlib = _value(imlib)
    interpolation = _value(interpolation)
    multispec = _scwave(array, scale_list, imlib=imlib,
                        interpolation=interpolation, collapse=None)[0]
    Y, X = multispec.shape[-2:]
    flux = None
    if flux_scal is not None:
        flux = as_tensor(_host_vec(flux_scal), multispec.device,
                         multispec.dtype)[:, None, None, None]
        multispec = multispec * flux

    if mode == "annular":
        if isinstance(delta_sep, tuple):
            delta_sep_vec = np.linspace(delta_sep[0], delta_sep[1], n_annuli)
        else:
            delta_sep_vec = [delta_sep] * n_annuli
        flat = multispec.reshape(z, N, Y * X)
        res = torch.zeros_like(flat)
        for ann in range(n_annuli):
            if ann == n_annuli - 1:
                inner_radius = radius_int + (ann * annulus_width - 1)
            else:
                inner_radius = radius_int + ann * annulus_width
            ann_center = inner_radius + (annulus_width / 2)
            yy, xx = get_annulus_segments((Y, X), inner_radius,
                                          annulus_width)[0]
            pix = torch.as_tensor(np.asarray(yy) * X + np.asarray(xx),
                                  device=flat.device)
            matrix = flat[:, :, pix]                        # (z, N, p)
            libs = [_find_indices_sdi(scal, ann_center, j, fwhm,
                                      delta_sep_vec[ann], nframes)
                    for j in range(z)]
            res[:, :, pix] = _channel_library_medians(matrix, libs)
        cube_res = res.reshape(z, N, Y, X)
    elif mode == "fullfr":
        # the channel medians of all frames: one call over (z, N·Y, X)
        med = _median0(multispec.reshape(z, N * Y, X), propagate=False)
        cube_res = multispec - med.reshape(1, N, Y, X)
    else:
        raise RuntimeError("Mode not recognized")
    if flux is not None:
        cube_res = cube_res / flux
    return _scwave(cube_res, scale_list, inverse=True, y_in=y_in, x_in=x_in,
                   imlib=imlib, interpolation=interpolation,
                   collapse=_value(collapse), keep_cube=False)[1]


def _channel_library_medians(matrix, libs):
    """residual[j] = matrix[j] − nanmedian(matrix[libs[j]], axis=0) for a
    (z, N, p) ``matrix`` and each channel's host library ``libs[j]``: the
    libraries padded with NaN to the longest and reduced in one median
    over (L, z·N, p)."""
    z, N, npx = matrix.shape
    L = max(len(lib) for lib in libs)
    padded = np.full((z, L), z, dtype=np.int64)     # row z is all NaN
    for j, lib in enumerate(libs):
        padded[j, :len(lib)] = lib
    ext = torch.cat([matrix, matrix.new_full((1, N, npx), torch.nan)])
    idx = torch.as_tensor(padded.T, device=matrix.device)       # (L, z)
    block = ext[idx].reshape(L, z * N, npx)
    return matrix - _median0(block, propagate=False).reshape(z, N, npx)

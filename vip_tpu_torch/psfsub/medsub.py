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
route of ``ops.shear.rotate_exact``, or fft-small) and collapsed. 4-d
(ADI+mSDI) cubes wait for ROADMAP Queue 1, slice 7.
"""

from dataclasses import dataclass
from enum import Enum
from typing import List, Union

import numpy as np
import torch

from ..config import Collapse, Imlib, Interpolation, time_ini, timing
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..ops.median import nanmedian_axis0, nanmedian_plain, nanmedian_supported
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
    otherwise (CPU, float64, more than 3600 frames)."""
    if nanmedian_supported(arr, 0):
        return nanmedian_axis0(arr.contiguous(), propagate=propagate)
    return nanmedian_plain(arr, 0, propagate=propagate)


def median_sub(*all_args: List, **all_kwargs: dict):
    """(Smart) median-ADI / median-RDI of a 3-d cube (vip_tpu
    medsub.py:69): same parameters (``MEDIAN_SUB_Params``, extra keywords
    are the derotation's ``rot_options``) and return values — the final
    frame, or (cube_out, cube_der, frame) with ``full_output`` — as
    tensors on the cube's device."""
    algo_params, rot_options = resolve_algo_params(
        MEDIAN_SUB_Params, all_args, all_kwargs)
    p = algo_params
    if p.radius_int and len(rot_options) == 0:
        rot_options["mask_val"] = 0
        rot_options["ker"] = 1
        rot_options["interp_zeros"] = True

    if getattr(p.cube, "ndim", None) == 4:
        raise NotImplementedError(
            "median_sub: 4-d (ADI+mSDI) cubes are not ported yet (ROADMAP.md,"
            " Queue 1, slice 7)")
    array = as_tensor(p.cube)
    if array.ndim != 3:
        raise TypeError("Input array is not a 3d or 4d array")
    array = array.clone()
    if p.verbose:
        start_time = time_ini()

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

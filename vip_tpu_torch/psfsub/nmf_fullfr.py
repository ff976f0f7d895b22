"""Full-frame NMF PSF subtraction (port of ``vip_tpu.psfsub.nmf_fullfr``).

The factorization is ``ops.nmf`` (sklearn's multiplicative updates) on the
cube's device; negative values are handled as in VIP ('mask': only pixels
positive in every frame, 'null': negatives set to zero, 'subtr_min': the
cube's minimum subtracted). The residuals are derotated by
``cube_derotate`` (CUDA kernel H2 on a float32 card cube) and collapsed
by ``cube_collapse`` (H1 for the median). Results are tensors on the
cube's device.

The 'nndsvdar' and 'random' inits draw from a ``torch.Generator`` seeded
with 0 (vip_tpu: ``jax.random.PRNGKey(0)``; the numbers differ, see
``ops.nmf``).
"""

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Tuple

import numpy as np
import torch

from ..config import Collapse, HandleNeg, Initsvd, time_ini, timing
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..ops.median import nanmedian_plain
from ..ops.nmf import nmf_fit, nmf_transform
from ..preproc.derotation import (_compute_pa_thresh, _find_indices_adi,
                                  cube_derotate)
from ..preproc.subsampling import cube_collapse
from ..var.coords import dist, frame_center
from ..var.shapes import mask_circle, matrix_scaling, prepare_matrix
from .pca_fullfr import _value

__all__ = ["nmf", "NMF_Params"]


@dataclass
class NMF_Params:
    """Parameters of ``nmf`` (vip_tpu nmf_fullfr.py:31). Arrays may be
    numpy arrays or tensors."""

    cube: object = None
    angle_list: object = None
    cube_ref: object = None
    ncomp: int = 1
    scaling: Enum = None
    max_iter: int = 10000
    random_state: int = None
    mask_center_px: int = None
    source_xy: Tuple[int] = None
    delta_rot: float = 1
    fwhm: float = 4
    init_svd: Enum = Initsvd.NNDSVD
    collapse: Enum = Collapse.MEDIAN
    full_output: bool = False
    verbose: bool = True
    cube_sig: object = None
    handle_neg: Enum = HandleNeg.MASK
    nmf_args: dict = field(default_factory=lambda: {})


def median_all(t):
    """``numpy.median`` of every value of a tensor (an even count takes
    the mean of the two middles)."""
    return nanmedian_plain(t.reshape(-1), 0)


def nmf(*all_args: List, **all_kwargs: dict):
    """NMF PSF subtraction of a 3-d ADI cube, with an optional reference
    cube and the per-frame PA-threshold libraries of ``source_xy``
    (vip_tpu nmf_fullfr.py:60).

    Returns the final frame, or with ``full_output`` (H, recon_cube,
    residuals_cube, residuals_cube_, frame), as tensors on the cube's
    device.
    """
    algo_params, rot_options = resolve_algo_params(
        NMF_Params, all_args, all_kwargs)
    p = algo_params

    array = as_tensor(p.cube).clone()
    if array.ndim != 3:
        raise TypeError("Input array is not a cube or 3d array")
    n, y, x = array.shape
    dev, dt = array.device, array.dtype
    cube_sig = None if p.cube_sig is None \
        else as_tensor(p.cube_sig, dev, dt).clone()
    cube_ref = None if p.cube_ref is None else as_tensor(p.cube_ref, dev, dt)
    start_time = time_ini(p.verbose) if p.verbose else None

    handle_neg = str(_value(p.handle_neg))
    init_svd = str(_value(p.init_svd))
    matrix_ref = matrix_sig = pix = None

    if handle_neg == "mask":
        if p.mask_center_px:
            array = mask_circle(array, p.mask_center_px)
        probe = array if cube_sig is None else array - cube_sig.abs()
        pix = torch.nonzero(probe.amin(dim=0).reshape(-1) > 0).squeeze(1)
        H_tmp = torch.zeros((p.ncomp, y * x), dtype=dt, device=dev)
        if pix.numel() == 0:
            raise ValueError("Remove frame(s) with negative values")
        matrix = matrix_scaling(array.reshape(n, -1)[:, pix], p.scaling)
        if cube_ref is not None:
            matrix_ref = matrix_scaling(
                cube_ref.reshape(cube_ref.shape[0], -1)[:, pix], p.scaling)
        if cube_sig is not None:
            matrix_sig = cube_sig.reshape(n, -1)[:, pix]
    else:
        # the signal-subtracted values decide when a cube_sig is given
        probe = array if cube_sig is None else array - cube_sig
        if handle_neg == "null":
            neg = probe < 0
            array = array.masked_fill(neg, 0)
            if cube_sig is not None:
                cube_sig = cube_sig.masked_fill(neg, 0)
        elif handle_neg == "subtr_min":
            array = array - probe.amin()
        else:
            raise ValueError("Mode to handle neg. pixels not recognized")
        matrix = prepare_matrix(array, p.scaling, p.mask_center_px,
                                mode="fullfr", verbose=p.verbose)
        if cube_ref is not None:
            matrix_ref = prepare_matrix(cube_ref, p.scaling,
                                        p.mask_center_px, mode="fullfr",
                                        verbose=p.verbose)
        if cube_sig is not None:
            matrix_sig = prepare_matrix(cube_sig, p.scaling,
                                        p.mask_center_px, mode="fullfr",
                                        verbose=p.verbose)

    residuals_cube = cube_sig.clone() if cube_sig is not None \
        else torch.zeros_like(array)
    flat_res = residuals_cube.view(n, -1)
    fit = dict(max_iter=p.max_iter, random_state=p.random_state,
               init_svd=init_svd, **p.nmf_args)

    if p.source_xy is None:
        residuals, reconstructed, H = _project_subtract(
            matrix, matrix_ref, p.ncomp, p.scaling, p.mask_center_px,
            p.verbose, True, matrix_sig=matrix_sig, **fit)
        if p.verbose:
            timing(start_time)
        recon_cube = residuals_cube.clone()
        if handle_neg == "mask":
            flat_res[:, pix] = residuals
            if p.full_output:
                recon_cube.view(n, -1)[:, pix] = reconstructed
                H_tmp[:, pix] = H
                H = H_tmp.reshape(p.ncomp, y, x)
        else:
            flat_res[:] = residuals
            if p.full_output:
                recon_cube = reconstructed.reshape(n, y, x)
                H = H.reshape(p.ncomp, y, x)
    else:
        if p.delta_rot is None or p.fwhm is None:
            raise TypeError("Delta_rot or fwhm parameters missing. Needed "
                            "for the PA-based rejection of frames from the "
                            "library")
        angle_list = np.asarray(
            p.angle_list.detach().cpu().numpy()
            if isinstance(p.angle_list, torch.Tensor) else p.angle_list,
            dtype=float)
        recon_cube = torch.zeros((n, y, x), dtype=dt, device=dev)
        yc, xc = frame_center((y, x), False)
        x1, y1 = p.source_xy
        pa_thr = _compute_pa_thresh(dist(yc, xc, y1, x1), p.fwhm,
                                    p.delta_rot)
        mid_range = np.abs(np.amax(angle_list) - np.amin(angle_list)) / 2
        if pa_thr >= mid_range - mid_range * 0.1:
            new_pa_th = float(mid_range - mid_range * 0.1)
            if p.verbose:
                print(f"PA threshold {pa_thr:.2f} is too big, will be set "
                      f"to {new_pa_th:.2f}")
            pa_thr = new_pa_th
        flat_rec = recon_cube.view(n, -1)
        for fr in range(n):
            ind = _find_indices_adi(angle_list, fr, pa_thr)
            residuals, recon_frame, H = _project_subtract(
                matrix, matrix_ref, p.ncomp, p.scaling, p.mask_center_px,
                p.verbose, True, indices=ind, frame=fr,
                matrix_sig=matrix_sig, **fit)
            if handle_neg == "mask":
                flat_rec[fr, pix] = recon_frame[0]
                flat_res[fr, pix] = residuals
            else:
                flat_rec[fr] = recon_frame[0]
                flat_res[fr] = residuals
        if p.full_output:
            if handle_neg == "mask":
                H_tmp[:, pix] = H
                H = H_tmp.reshape(p.ncomp, y, x)
            else:
                H = H.reshape(p.ncomp, y, x)

    if p.verbose:
        print("Done NMF with device multiplicative updates.")
        timing(start_time)

    residuals_cube_ = cube_derotate(residuals_cube, p.angle_list,
                                    **rot_options)
    frame = cube_collapse(residuals_cube_, mode=_value(p.collapse))
    if p.verbose:
        print("Done derotating and combining.")
        timing(start_time)
    if p.full_output:
        return H, recon_cube, residuals_cube, residuals_cube_, frame
    return frame


def _project_subtract(matrix, matrix_ref, ncomp, scaling, mask_center_px,
                      verbose, full_output, indices=None, frame=None,
                      matrix_sig=None, max_iter=100, random_state=None,
                      init_svd="nndsvda", **kwargs):
    """NMF fit of the library, projection of the (signal-subtracted)
    target and subtraction (vip_tpu nmf_fullfr.py:203): the whole matrix,
    or frame ``frame`` against the library rows ``indices``."""
    matrix_emp = matrix if matrix_sig is None else matrix - matrix_sig
    per_frame = indices is not None and frame is not None
    if matrix_ref is not None:
        ref_lib = matrix_ref
    elif per_frame:
        ref_lib = matrix_emp[torch.as_tensor(np.asarray(indices, np.int64),
                                             device=matrix.device)]
    else:
        ref_lib = matrix_emp
    if bool(median_all(ref_lib) < 0):
        raise ValueError("Mostly negative values in the cube")
    ref_lib = ref_lib.clamp(min=0)
    if per_frame and ref_lib.shape[0] <= 10:
        raise RuntimeError("Less than 10 frames left in the PCA library"
                           ", Try decreasing the parameter delta_rot")

    target = matrix_emp[frame][None] if per_frame else matrix_emp
    _, H, _ = nmf_fit(ref_lib, ncomp, max_iter=max_iter, init=init_svd)
    W = nmf_transform(target, H, max_iter=max_iter)
    reconstructed = W @ H
    raw = matrix[frame] if per_frame else matrix
    residuals = raw - reconstructed
    if full_output:
        return residuals, reconstructed, H
    return residuals

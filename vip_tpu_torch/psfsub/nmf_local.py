"""Annular NMF PSF subtraction (port of ``vip_tpu.psfsub.nmf_local``).

The annulus and segment geometry of ``pca_annular``, with one NMF fit per
frame and segment. Where vip_tpu batches the per-frame fits
(``_nmf_patches_batched``: no reference or signal cube, an NNDSVD init,
no ``nmf_args``, ``VIP_TPU_NMF_BATCHED`` not "0"), each frame's
PA-thresholded library is gathered on the device, zero-row-padded to a
common size, and fitted with ``ops.nmf.nmf_patch_batched`` in chunks of
frames sized to a memory budget; otherwise each frame is fitted on its
own (``do_nmf_patch``). The residual cube is derotated by
``cube_derotate`` (H2 on a float32 card cube) and collapsed by
``cube_collapse`` (H1 for the median).
"""

import os
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Tuple, Union

import numpy as np
import torch

from ..config import (Collapse, HandleNeg, Imlib, Initsvd, Interpolation,
                      time_ini, timing)
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..ops.median import nanmedian_plain
from ..ops.nmf import _normal_pair, nmf_fit, nmf_patch_batched, nmf_transform
from ..preproc.derotation import (_define_annuli, _find_indices_adi,
                                  cube_derotate)
from ..preproc.parangles import check_pa_vector
from ..preproc.subsampling import cube_collapse
from ..var.shapes import (get_annulus_segments, matrix_scaling,
                          resolve_n_segments)
from .nmf_fullfr import median_all
from .pca_fullfr import _value

__all__ = ["nmf_annular", "NMF_ANNULAR_Params"]

# Working set of one chunk of batched per-frame fits: the (B, L, p)
# libraries and about five temporaries of their size in the updates
_BATCH_BUDGET_BYTES = 8 << 30
_BATCH_COPIES = 6


def _nmf_batched_enabled():
    return os.environ.get("VIP_TPU_NMF_BATCHED", "1") == "1"


def _frame_libraries(angle_list, pa_thr, n, min_frames_lib, max_frames_lib):
    """Each frame's library (host index arrays): the PA threshold and the
    ΔPA truncation, or every frame when the threshold is 0."""
    msg = ("Too few frames left in the PCA library. Accepted indices "
           "length ({:.0f}) less than {:.0f}. Try decreasing either "
           "delta_rot or min_frames_lib.")
    libs = []
    for fr in range(n):
        if pa_thr != 0:
            idx = _find_indices_adi(angle_list, fr, pa_thr, truncate=True,
                                    max_frames=max_frames_lib)
            if len(idx) < min_frames_lib:
                raise RuntimeError(msg.format(len(idx), min_frames_lib))
            libs.append(np.asarray(idx, np.int64))
        else:
            libs.append(np.arange(n))
    return libs


def _nmf_patches_batched(matrix_segm, angle_list, pa_thr, ncomp, max_iter,
                         init_svd, min_frames_lib, max_frames_lib,
                         handle_neg):
    """Every frame's NMF patch of one segment in batches (vip_tpu
    nmf_local.py:35): the libraries zero-row-padded to a shared L (a
    multiple of 16), ``handle_neg`` applied to each frame's own rows, the
    fits in chunks of frames that fit ``_BATCH_BUDGET_BYTES``. The chunks
    share one nndsvdar draw, as vip_tpu's frames do. Returns (residuals
    (n, p), recon (n, p), H of frame 0 (k, p))."""
    n, p = matrix_segm.shape
    dev, dt = matrix_segm.device, matrix_segm.dtype
    libs = _frame_libraries(angle_list, pa_thr, n, min_frames_lib,
                            max_frames_lib)
    L = max(len(i) for i in libs)
    L_pad = 16 * ((L + 15) // 16)
    index = np.zeros((n, L_pad), np.int64)
    valid = np.zeros((n, L_pad), bool)
    for fr, idx in enumerate(libs):
        index[fr, :len(idx)] = idx
        valid[fr, :len(idx)] = True
    index = torch.as_tensor(index, device=dev)
    valid = torch.as_tensor(valid, device=dev)

    curr = matrix_segm
    if handle_neg == "null":
        curr = curr.clamp(min=0)
    elif handle_neg == "subtr_min":
        curr = curr - curr.amin(dim=1, keepdim=True)
    # 'mask': the segment holds only pixels positive in every frame

    draws = None
    if init_svd == "nndsvdar":
        draws = _normal_pair(None, (L_pad, int(ncomp)), (int(ncomp), p), dt,
                             dev, None)
    per_frame = _BATCH_COPIES * L_pad * p * matrix_segm.element_size()
    chunk = int(max(1, min(n, _BATCH_BUDGET_BYTES // per_frame)))
    recon = torch.empty_like(matrix_segm)
    H0 = None
    for s in range(0, n, chunk):
        sl = slice(s, min(n, s + chunk))
        rows = valid[sl][:, :, None]
        X = matrix_segm[index[sl]]
        med = nanmedian_plain(
            torch.where(rows, X, torch.nan).reshape(X.shape[0], -1).T, 0)
        if bool((med < 0).any()):
            raise ValueError("Mostly negative values in the cube")
        if handle_neg == "null":
            X = X.clamp(min=0)
        elif handle_neg == "subtr_min":
            X = X - torch.where(rows, X, torch.inf).amin(dim=(1, 2),
                                                         keepdim=True)
        X = torch.where(rows, X, 0.0)
        rec, H_all = nmf_patch_batched(X, valid[sl].to(dt), curr[sl],
                                       int(ncomp), max_iter=int(max_iter),
                                       variant=str(init_svd), draws=draws)
        recon[sl] = rec
        if H0 is None:
            H0 = H_all[0]
    return matrix_segm - recon, recon, H0


@dataclass
class NMF_ANNULAR_Params:
    """Parameters of ``nmf_annular`` (vip_tpu nmf_local.py:113). Arrays may
    be numpy arrays or tensors."""

    cube: object = None
    angle_list: object = None
    cube_ref: object = None
    radius_int: int = 0
    fwhm: float = 4
    asize: int = 4
    n_segments: int = 1
    delta_rot: Union[float, Tuple[float]] = (0.1, 1)
    ncomp: int = 1
    init_svd: Enum = Initsvd.NNDSVD
    nproc: int = 1
    min_frames_lib: int = 2
    max_frames_lib: int = 200
    scaling: Enum = None
    imlib: Enum = Imlib.VIPFFT
    interpolation: Enum = Interpolation.LANCZOS4
    collapse: Enum = Collapse.MEDIAN
    full_output: bool = False
    verbose: bool = True
    theta_init: float = 0
    weights: List = None
    cube_sig: object = None
    handle_neg: Enum = HandleNeg.MASK
    max_iter: int = 1000
    random_state: int = None
    nmf_args: dict = field(default_factory=lambda: {})


def nmf_annular(*all_args: List, **all_kwargs: dict):
    """NMF PSF subtraction in concentric annuli (vip_tpu
    nmf_local.py:146). Returns the final frame, or with ``full_output``
    (cube_out, cube_der, cube_recon, H_comps, frame), as tensors on the
    cube's device."""
    algo_params, rot_options = resolve_algo_params(
        NMF_ANNULAR_Params, all_args, all_kwargs)
    p = algo_params
    start_time = time_ini() if p.verbose else None

    array = as_tensor(p.cube)
    if array.ndim != 3:
        raise TypeError("Input array is not a cube or 3d array")
    if array.shape[0] != len(p.angle_list):
        raise TypeError("Input vector or parallactic angles has wrong length")
    dev, dt = array.device, array.dtype
    cube_sig = None if p.cube_sig is None else as_tensor(p.cube_sig, dev, dt)
    cube_ref = None if p.cube_ref is None else as_tensor(p.cube_ref, dev, dt)

    n, y, x = array.shape
    angle_list = check_pa_vector(p.angle_list)
    n_annuli = int((y / 2 - p.radius_int) / p.asize)
    delta_rot = p.delta_rot
    if isinstance(delta_rot, tuple):
        delta_rot = np.linspace(delta_rot[0], delta_rot[1], num=n_annuli)
    elif np.isscalar(delta_rot):
        delta_rot = [delta_rot] * n_annuli
    n_segments = resolve_n_segments(p.n_segments, n_annuli, p.asize)
    if p.verbose:
        print(f"N annuli = {n_annuli}, FWHM = {p.fwhm:.3f}")
        print("NMF per annulus (or annular sectors):")

    handle_neg = str(_value(p.handle_neg))
    init_svd = str(_value(p.init_svd))
    nc_max = int(np.max(p.ncomp))
    cube_out = torch.zeros_like(array)
    cube_recon = torch.zeros_like(array)
    H_comps = torch.zeros((nc_max, y, x), dtype=dt, device=dev)
    flat = array.reshape(n, -1)
    strict = cube_ref is not None

    for ann in range(n_annuli):
        if isinstance(p.ncomp, (tuple, np.ndarray)):
            if len(p.ncomp) != n_annuli:
                raise TypeError("If `ncomp` is a tuple, it must match the "
                                "number of annuli")
            ncompann = p.ncomp[ann]
        else:
            ncompann = p.ncomp
        n_segments_ann = n_segments[ann]
        pa_thr, inner_radius, ann_center = _define_annuli(
            angle_list, ann, n_annuli, p.fwhm, p.radius_int, p.asize,
            delta_rot[ann], n_segments_ann, p.verbose, strict)
        indices = get_annulus_segments((y, x), inner_radius, p.asize,
                                       n_segments_ann, p.theta_init)
        for j in range(n_segments_ann):
            yy, xx = indices[j]
            pix = torch.as_tensor(yy * x + xx, device=dev)
            if handle_neg == "mask":
                vals = flat[:, pix]
                if cube_sig is not None:
                    vals = vals - cube_sig.reshape(n, -1)[:, pix].abs()
                pix = pix[vals.amin(dim=0) > 0]
                if pix.numel() == 0:
                    continue    # no pixel of the segment is positive
            matrix_segm = matrix_scaling(flat[:, pix], p.scaling)
            matrix_segm_ref = None if cube_ref is None else matrix_scaling(
                cube_ref.reshape(cube_ref.shape[0], -1)[:, pix], p.scaling)
            matrix_sig_segm = None if cube_sig is None \
                else cube_sig.reshape(n, -1)[:, pix]

            batched = (matrix_sig_segm is None and matrix_segm_ref is None
                       and init_svd.startswith("nndsvd")
                       and not p.nmf_args and _nmf_batched_enabled())
            if batched:
                res, recon, H0 = _nmf_patches_batched(
                    matrix_segm, angle_list, pa_thr, ncompann, p.max_iter,
                    init_svd, p.min_frames_lib, p.max_frames_lib,
                    handle_neg)
                cube_out.view(n, -1)[:, pix] = res
                cube_recon.view(n, -1)[:, pix] = recon
                k = min(nc_max, H0.shape[0])
                H_comps.view(nc_max, -1)[:k, pix] = H0[:k]
                continue
            for fr in range(n):
                res, recon, H = do_nmf_patch(
                    matrix_segm, fr, angle_list, p.fwhm, pa_thr, ann_center,
                    ncompann, p.max_iter, p.random_state, init_svd,
                    p.min_frames_lib, p.max_frames_lib, matrix_segm_ref,
                    matrix_sig_segm, handle_neg, **p.nmf_args)
                cube_out.view(n, -1)[fr, pix] = res
                cube_recon.view(n, -1)[fr, pix] = recon
                if fr == 0:
                    k = min(nc_max, H.shape[0])
                    H_comps.view(nc_max, -1)[:k, pix] = H[:k]
        if p.verbose:
            timing(start_time)

    cube_der = cube_derotate(cube_out, angle_list, nproc=p.nproc,
                             imlib=_value(p.imlib),
                             interpolation=_value(p.interpolation),
                             **rot_options)
    frame = cube_collapse(cube_der, mode=_value(p.collapse), w=p.weights)
    if p.verbose:
        print("Done derotating and combining.")
        timing(start_time)
    if p.full_output:
        return cube_out, cube_der, cube_recon, H_comps, frame
    return frame


def do_nmf_patch(matrix, frame, angle_list, fwhm, pa_threshold, ann_center,
                 ncomp, max_iter, random_state, init_svd, min_frames_lib,
                 max_frames_lib, matrix_ref, matrix_sig_segm, handle_neg,
                 **kwargs):
    """NMF of one frame's patch against its library (vip_tpu
    nmf_local.py:271). Returns (residuals, reconstructed, H) on the
    matrix's device, H and the reconstruction zero outside the 'mask'
    pixels."""
    dev = matrix.device
    data_ref = None
    if pa_threshold != 0:
        indices_left = _find_indices_adi(angle_list, frame, pa_threshold,
                                         truncate=True,
                                         max_frames=max_frames_lib)
        msg = ("Too few frames left in the PCA library. Accepted indices "
               "length ({:.0f}) less than {:.0f}. Try decreasing either "
               "delta_rot or min_frames_lib.")
        if len(indices_left) == 0 and matrix_ref is None:
            raise RuntimeError(msg.format(0, min_frames_lib))
        if len(indices_left) > 0:
            idx = torch.as_tensor(np.asarray(indices_left, np.int64),
                                  device=dev)
            data_ref = matrix[idx]
            if matrix_sig_segm is not None:
                data_ref = data_ref - matrix_sig_segm[idx]
        if len(indices_left) < min_frames_lib and matrix_ref is None:
            raise RuntimeError(msg.format(len(indices_left), min_frames_lib))
    else:
        data_ref = matrix if matrix_sig_segm is None \
            else matrix - matrix_sig_segm
    if matrix_ref is not None:
        data_ref = matrix_ref if data_ref is None \
            else torch.cat((matrix_ref, data_ref))

    if bool(median_all(data_ref) < 0):
        raise ValueError("Mostly negative values in the cube")
    curr_frame = matrix[frame]
    curr_frame_emp = curr_frame if matrix_sig_segm is None \
        else curr_frame - matrix_sig_segm[frame]
    pos_p = None
    if handle_neg == "null":
        data_ref = data_ref.clamp(min=0)
        curr_frame_emp = curr_frame_emp.clamp(min=0)
    elif handle_neg == "subtr_min":
        data_ref = data_ref - data_ref.amin()
        curr_frame_emp = curr_frame_emp - curr_frame_emp.amin()
    else:  # 'mask'
        pos_p = torch.nonzero((data_ref.amin(dim=0) > 0)
                              & (curr_frame_emp > 0)).squeeze(1)
        curr_frame_emp = curr_frame_emp[pos_p]
        data_ref = data_ref[:, pos_p]

    _, H, _ = nmf_fit(data_ref, int(ncomp), max_iter=max_iter, init=init_svd)
    W = nmf_transform(curr_frame_emp[None], H, max_iter=max_iter)
    reconstructed = (W @ H)[0]
    if pos_p is not None:
        recon = torch.zeros(matrix.shape[1], dtype=matrix.dtype, device=dev)
        recon[pos_p] = reconstructed
        reconstructed = recon
        H_full = torch.zeros((int(ncomp), matrix.shape[1]),
                             dtype=matrix.dtype, device=dev)
        H_full[:, pos_p] = H
        H = H_full
    return curr_frame - reconstructed, reconstructed, H

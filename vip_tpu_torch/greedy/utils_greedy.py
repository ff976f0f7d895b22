"""Helpers of the greedy algorithms (port of
``vip_tpu.greedy.utils_greedy``): the significant-signal mask from the
normalized STIM map, and masked Gaussian blurring. Tensors on the input's
device."""

import numpy as np
import torch

from ..config.device import as_tensor
from ..metrics.stim import inverse_stim_map, stim_map
from ..var.filters import frame_filter_lowpass
from ..var.shapes import mask_circle

__all__ = ["find_significant_signals", "blurring_2d", "blurring_3d"]


def find_significant_signals(residuals_cube, residuals_cube_, angle_list,
                             thr, mask=0, r_out=None, r_max=None):
    """Mask of the pixels whose STIM map, normalized by the largest value
    of the inverse STIM map, exceeds ``thr`` ('auto': that largest value
    between ``r_out`` and ``r_max``, over the overall one), and the
    normalized map (vip_tpu utils_greedy.py:17)."""
    stim = stim_map(residuals_cube_)
    inv_stim = inverse_stim_map(residuals_cube, angle_list)
    if mask:
        inv_stim = mask_circle(inv_stim, mask)
    max_inv = inv_stim.max()
    if float(max_inv) == 0:
        max_inv = torch.ones_like(max_inv)
    if thr == "auto":
        n = residuals_cube.shape[-1]
        r_out = n // 4 if r_out is None else r_out
        r_max = n // 2 if r_max is None else r_max
        inv_stim_rout = mask_circle(inv_stim, r_out)
        inv_stim_rmax = mask_circle(inv_stim_rout, r_max, mode="out")
        thr = inv_stim_rmax.max() / max_inv
    norm_stim = stim / max_inv
    good_mask = (norm_stim > thr).to(stim.dtype)
    return good_mask, norm_stim


def _lowpass(array, fwhm_sz):
    if np.isscalar(fwhm_sz):
        return frame_filter_lowpass(array, mode="gauss", fwhm_size=fwhm_sz,
                                    iterate=False)
    return frame_filter_lowpass(array, mode="psf", psf=fwhm_sz,
                                iterate=False)


def blurring_2d(array, mask_center_sz, fwhm_sz=2):
    """Gaussian (or PSF) blur of a frame, only outside a central mask of
    radius ``mask_center_sz`` when one is given (vip_tpu
    utils_greedy.py:45)."""
    array = as_tensor(array)
    if mask_center_sz:
        frame_mask = mask_circle(array, radius=mask_center_sz + fwhm_sz,
                                 fillwith=np.nan, mode="out")
        frame_mask2 = mask_circle(array, radius=mask_center_sz,
                                  fillwith=np.nan, mode="out")
        frame_filt = _lowpass(frame_mask, fwhm_sz)
        return torch.where(torch.isfinite(frame_mask2), frame_filt, array)
    return _lowpass(array, fwhm_sz)


def blurring_3d(array, mask_center_sz, fwhm_sz=2):
    """:func:`blurring_2d` of every frame (vip_tpu utils_greedy.py:68)."""
    array = as_tensor(array)
    return torch.stack([blurring_2d(array[i], mask_center_sz, fwhm_sz)
                        for i in range(array.shape[0])])

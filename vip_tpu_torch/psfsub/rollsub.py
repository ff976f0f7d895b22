"""Roll subtraction of two-roll-angle sequences, as JWST and HST image
(port of ``vip_tpu.psfsub.rollsub``).

The frames of each roll are subtracted from those (or the mean) of the
other roll on the cube's device; the differences are rotated by
``cube_derotate`` ('individual') or ``frame_rotate`` ('mean'), both the
exact FFT rotation (H2 on a float32 card frame), and combined by
``cube_collapse`` (its default here is the mean).
"""

from dataclasses import dataclass
from enum import Enum
from typing import List

import numpy as np
import torch

from ..config import Collapse, Imlib, Interpolation, time_ini, timing
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..preproc.derotation import cube_derotate, frame_rotate
from ..preproc.subsampling import cube_collapse
from ..var.filters import cube_filter_lowpass, frame_filter_lowpass
from ..var.shapes import mask_circle
from .pca_fullfr import _value

__all__ = ["roll_sub", "ROLL_SUB_Params"]


@dataclass
class ROLL_SUB_Params:
    """Parameters of ``roll_sub`` (vip_tpu rollsub.py:24). Arrays may be
    numpy arrays or tensors."""

    cube: object = None
    angle_list: object = None
    mode: str = "mean"
    imlib: Enum = Imlib.VIPFFT
    interpolation: Enum = Interpolation.LANCZOS4
    collapse: Enum = Collapse.MEAN
    smooth_ker_bef: float = 0.0
    smooth_ker_aft: float = 0.0
    mask_rad: float = 0.0
    cube_sig: object = None
    nproc: int = 1
    full_output: bool = False
    verbose: bool = True


def _host_angles(angle_list):
    """Angles as a float64 host array (from numpy, a list or a tensor)."""
    return np.asarray(angle_list.detach().cpu().numpy()
                      if isinstance(angle_list, torch.Tensor) else angle_list,
                      dtype=float)


def roll_sub(*all_args: List, **all_kwargs: dict):
    """Roll subtraction (vip_tpu rollsub.py:43). ``cube`` is a 3-d cube
    whose first half is the first roll, or a tuple of the two rolls'
    cubes; ``angle_list`` has one angle a frame, or the two roll angles.
    Returns the final frame, or with ``full_output`` (cube_res, cube_der,
    frame), as tensors on the cube's device."""
    algo_params, rot_options = resolve_algo_params(
        ROLL_SUB_Params, all_args, all_kwargs)
    p = algo_params

    angle_list = _host_angles(p.angle_list)
    mang = np.mean(angle_list)
    if len(angle_list) == 2:
        ang1, ang2 = angle_list
    else:
        ang1 = np.mean(angle_list[np.where(angle_list <= mang)])
        ang2 = np.mean(angle_list[np.where(angle_list > mang)])

    if isinstance(p.cube, tuple):
        first = as_tensor(p.cube[0])
        nh1, nh2 = len(p.cube[0]), len(p.cube[1])
        ARRAY = torch.cat((first, as_tensor(p.cube[1], first.device,
                                            first.dtype)))
        angle_list = np.array([ang1] * nh1 + [ang2] * nh2)
    elif as_tensor(p.cube).ndim == 3:
        ARRAY = as_tensor(p.cube)
        nfr = ARRAY.shape[0]
        nh1, nh2 = nfr // 2, nfr - nfr // 2
        if len(angle_list) != nfr:
            if len(angle_list) == 2:
                angle_list = np.array([ang1] * nh1 + [ang2] * nh2)
            else:
                raise ValueError(f"Input angle_list has wrong length (should"
                                 f" be 2 or {nfr}")
    else:
        raise TypeError("Input array is not a 3d array or tuple of 2 3d "
                        "arrays")
    start_time = time_ini() if p.verbose else None

    cube = ARRAY
    if np.isscalar(p.smooth_ker_bef):
        if p.smooth_ker_bef > 0:
            cube = cube_filter_lowpass(ARRAY, fwhm_size=p.smooth_ker_bef)
    elif p.smooth_ker_bef.ndim == 2:
        cube = cube_filter_lowpass(ARRAY, mode="psf", psf=p.smooth_ker_bef)
    cube_ref = cube if p.cube_sig is None \
        else cube - as_tensor(p.cube_sig, cube.device, cube.dtype)

    idx1 = torch.as_tensor(np.where(angle_list <= mang)[0],
                           device=cube.device)
    idx2 = torch.as_tensor(np.where(angle_list > mang)[0], device=cube.device)
    imlib, interpolation = _value(p.imlib), _value(p.interpolation)
    if p.mode == "individual":
        if nh1 != nh2:
            raise ValueError("In 'individual' mode, the same number of "
                             "images is required for both roll angles.")
        cube_res = torch.cat((cube[idx1] - cube_ref[idx2],
                              cube[idx2] - cube_ref[idx1]))
        cube_der = cube_derotate(cube_res, angle_list, imlib=imlib,
                                 interpolation=interpolation, nproc=p.nproc,
                                 **rot_options)
        finroll = cube_collapse(cube_der, mode=_value(p.collapse))
    else:
        mr1, mr2 = cube[idx1].mean(dim=0), cube[idx2].mean(dim=0)
        arr1, arr2 = cube_ref[idx1].mean(dim=0), cube_ref[idx2].mean(dim=0)
        a1 = np.mean(-angle_list[np.where(angle_list <= mang)])
        a2 = np.mean(-angle_list[np.where(angle_list > mang)])
        dr12, dr21 = mr1 - arr2, mr2 - arr1
        dr12_drot = frame_rotate(dr12, a1, imlib=imlib,
                                 interpolation=interpolation, **rot_options)
        dr21_drot = frame_rotate(dr21, a2, imlib=imlib,
                                 interpolation=interpolation, **rot_options)
        cube_res = torch.stack([dr12, dr21])
        cube_der = torch.stack([dr12_drot, dr21_drot])
        finroll = cube_collapse(cube_der, mode=_value(p.collapse))

    if np.isscalar(p.smooth_ker_aft):
        if p.smooth_ker_aft > 0:
            finroll = frame_filter_lowpass(finroll,
                                           fwhm_size=p.smooth_ker_aft)
    elif p.smooth_ker_aft.ndim == 2:
        finroll = frame_filter_lowpass(finroll, mode="psf",
                                       psf=p.smooth_ker_aft)
    if p.mask_rad > 0:
        finroll = mask_circle(finroll, p.mask_rad)
    if p.verbose:
        print("Done derotating and combining")
        timing(start_time)
    if p.full_output:
        return cube_res, cube_der, finroll
    return finroll

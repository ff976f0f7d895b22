"""Iterative roll subtraction (port of ``vip_tpu.greedy.irollsub``): the
port's ``roll_sub`` on the cube's device, repeated with the significant
signal of the previous pass, rotated into every frame, as its
``cube_sig``. Results are tensors on the cube's device."""

from dataclasses import dataclass
from typing import List, Union

import torch

from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params, separate_kwargs_dict
from ..preproc.derotation import cube_derotate
from ..psfsub.rollsub import ROLL_SUB_Params, _host_angles, roll_sub
from .ipca_fullfr import _repeat
from .utils_greedy import find_significant_signals

__all__ = ["iroll", "IROLL_SUB_Params"]


@dataclass
class IROLL_SUB_Params(ROLL_SUB_Params):
    """Parameters of ``iroll`` (vip_tpu irollsub.py:19)."""

    nit: int = 1
    thr: Union[float, str] = 0.0
    thr_mode: str = "STIM"
    r_out: float = None
    r_max: float = None


def iroll(*all_args: List, **all_kwargs: dict):
    """Iterative roll subtraction (vip_tpu irollsub.py:30). Returns the
    final frame, or with ``full_output`` (cube_res, cube_der, frame,
    the frames of every pass), as tensors on the cube's device."""
    algo_params, rot_options = resolve_algo_params(
        IROLL_SUB_Params, all_args, all_kwargs)
    p = algo_params
    roll_params, _ = separate_kwargs_dict(
        initial_kwargs=separate_kwargs_dict(all_kwargs, IROLL_SUB_Params)[0],
        parent_class=ROLL_SUB_Params)
    roll_params["full_output"] = True
    array = as_tensor(p.cube)
    nframes = array.shape[0]
    angles = _host_angles(p.angle_list)

    def sig_cube_from(roll_img, cube_res, cube_der):
        if p.thr_mode == "STIM":
            sig_mask, _ = find_significant_signals(
                cube_res, cube_der, angles, p.thr, mask=p.mask_rad,
                r_out=p.r_out)
        else:
            sig_mask = (roll_img >= p.thr).to(roll_img.dtype)
        img_cube = cube_derotate(_repeat(roll_img, nframes), -angles,
                                 **rot_options)
        sig_cube = cube_derotate(_repeat(sig_mask, nframes), -angles,
                                 imlib="skimage", interpolation="bilinear")
        return img_cube * (sig_cube >= 0.5).to(img_cube.dtype)

    cube_res, cube_der, rolli = roll_sub(**roll_params, **rot_options)
    img_cube = sig_cube_from(rolli, cube_res, cube_der)
    all_rolli = [rolli]
    for _ in range(p.nit):
        roll_params["cube"] = array
        roll_params["cube_sig"] = img_cube
        cube_res, cube_der, rolli = roll_sub(**roll_params, **rot_options)
        img_cube = sig_cube_from(rolli, cube_res, cube_der)
        all_rolli.append(rolli)
    if p.full_output:
        return cube_res, cube_der, rolli, torch.stack(all_rolli)
    return rolli

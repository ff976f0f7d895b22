"""STIM detection maps ([PAI19]; port of ``vip_tpu.metrics.stim``).

The maps are computed on the residual cube's device; the derotations go
through ``preproc.cube_derotate`` (CUDA kernel H2 for 'vip-fft' on the
card). Maps are tensors.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..preproc.derotation import cube_derotate
from ..var.shapes import get_circle, mask_circle

__all__ = ["stim_map", "inverse_stim_map", "normalized_stim_map"]


def stim_map(cube_der):
    """STIM map: the temporal mean over the temporal standard deviation of
    a derotated residual cube, zero where the deviation is zero, inside
    the inscribed circle (vip_tpu stim.py:11)."""
    cube_der = as_tensor(cube_der)
    n = cube_der.shape[1]
    mu = cube_der.mean(dim=0)
    sigma = torch.sqrt(cube_der.var(dim=0, correction=0))
    detection_map = torch.where(sigma != 0, mu / sigma, 0.0)
    return get_circle(detection_map, int(np.round(n / 2.0)))


def inverse_stim_map(cube, angle_list, **rot_options):
    """STIM map of the residual cube derotated by the opposite angles
    (vip_tpu stim.py:22)."""
    angles = -np.asarray(angle_list.detach().cpu() if isinstance(
        angle_list, torch.Tensor) else angle_list, dtype=float)
    return stim_map(cube_derotate(cube, angles, **rot_options))


def normalized_stim_map(cube, angle_list, mask=None, **rot_options):
    """STIM map divided by the largest value of the inverse STIM map
    (vip_tpu stim.py:29); ``mask`` (a radius, or an array) applies to the
    inverse map."""
    cube = as_tensor(cube)
    inv_map = inverse_stim_map(cube, angle_list, **rot_options)
    if mask is not None:
        if np.isscalar(mask):
            inv_map = mask_circle(inv_map, mask)
        else:
            inv_map = inv_map * as_tensor(mask, inv_map.device,
                                          inv_map.dtype)
    max_inv = float(torch.where(torch.isnan(inv_map), -torch.inf,
                                inv_map).max())
    if max_inv <= 0:
        raise ValueError(f"The normalization value is found to be {max_inv}")
    return stim_map(cube_derotate(cube, angle_list, **rot_options)) / max_inv

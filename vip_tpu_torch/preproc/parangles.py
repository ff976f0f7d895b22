"""Parallactic-angle helpers (port of ``vip_tpu.preproc.parangles``)."""

import numpy as np
import torch

__all__ = ["check_pa_vector"]


def check_pa_vector(angle_list, unit="deg"):
    """Normalize a derotation-angle vector: degrees, positive, no >180 deg
    jumps (vip_tpu parangles.py:212). Angles are host control data: the
    result is a float64 numpy array."""
    if isinstance(angle_list, torch.Tensor):
        angle_list = angle_list.detach().cpu().numpy()
    angle_list = np.asarray(angle_list, dtype=float).copy()
    if unit not in ("rad", "deg"):
        raise ValueError("The input unit should either be 'deg' or 'rad'")
    if unit == "rad":
        angle_list = np.rad2deg(angle_list)
    angle_list = np.where(angle_list < 0, 360 + angle_list, angle_list)
    if np.any(np.abs(np.diff(angle_list)) > 180):
        angle_list = np.where(angle_list < 180, 360 + angle_list,
                              angle_list)
    return angle_list

"""Masks and cube→matrix conversion (port of the part of
``vip_tpu.var.shapes`` that full-frame PCA runs on).

The pixel selection (strict ``< 1`` normalized distance, skimage.draw
semantics) is built on the host as static geometry and applied to the
tensor on its own device.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..ops.linalg import matrix_scaling_jax
from .coords import frame_center

__all__ = ["mask_circle", "matrix_scaling", "prepare_matrix",
           "reshape_matrix"]


def _disk(shape, cy, cx, radius):
    """Boolean (y, x) map of the pixels strictly inside a circle
    (skimage.draw.disk semantics, vip_tpu shapes.py:40-52)."""
    yy, xx = np.ogrid[0:float(shape[0]), 0:float(shape[1])]
    return ((yy - cy) / radius) ** 2 + ((xx - cx) / radius) ** 2 < 1


def mask_circle(array, radius, fillwith=0, mode="in", cy=None, cx=None,
                output="masked_arr"):
    """Mask the pixels inside (``mode="in"``) or outside (``"out"``) a
    circle of a 2d/3d/4d tensor (vip_tpu shapes.py:55). ``output=
    "bool_mask"`` returns the (y, x) bool tensor that is False inside."""
    if not isinstance(fillwith, (int, float)):
        raise ValueError("`fillwith` must be integer, float or np.nan")
    array = as_tensor(array)
    if cy is None or cx is None:
        cy, cx = frame_center(array)
    shape = tuple(array.shape[-2:])

    if radius == 0:
        keep = mode == "in"
        if output == "bool_mask":
            return torch.full(shape, keep, dtype=torch.bool,
                              device=array.device)
        return array.clone() if keep else torch.zeros_like(array)

    inside = torch.as_tensor(_disk(shape, cy, cx, radius),
                             device=array.device)
    if output == "bool_mask":
        return ~inside
    if mode == "in":
        return array.masked_fill(inside, fillwith)
    elif mode == "out":
        return array.masked_fill(~inside, fillwith)
    raise ValueError("mode not recognized")


def matrix_scaling(matrix, scaling):
    """Scale a matrix (sklearn.preprocessing.scale semantics; vip_tpu
    shapes.py:432)."""
    return matrix_scaling_jax(as_tensor(matrix), scaling)


def prepare_matrix(array, scaling=None, mask_center_px=None, mode="fullfr",
                   inner_radius=None, outer_radius=None,
                   discard_mask_pix=False, verbose=True):
    """Build the [n_frames, n_px] matrix for SVD/PCA (vip_tpu
    shapes.py:458). Only the full-frame mode is ported."""
    if mode != "fullfr":
        raise NotImplementedError(
            "prepare_matrix: only mode='fullfr' is ported (annular mode "
            "waits for ROADMAP Queue 1, slice 2)")
    array = as_tensor(array)
    if mask_center_px:
        if discard_mask_pix:
            keep = mask_circle(array, mask_center_px, output="bool_mask")
            array = array[:, keep]
        else:
            array = mask_circle(array, mask_center_px)
    matrix = matrix_scaling_jax(array.reshape(array.shape[0], -1), scaling)
    if verbose:
        print("Done vectorizing the frames. Matrix shape: "
              f"({matrix.shape[0]}, {matrix.shape[1]})")
    return matrix


def reshape_matrix(array, y, x):
    """Matrix of vectorized frames → cube (vip_tpu shapes.py:497)."""
    return as_tensor(array).reshape(array.shape[0], y, x)

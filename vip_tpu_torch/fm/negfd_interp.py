"""Disk model grid interpolation for NEGFD (port of
``vip_tpu.fm.negfd_interp``).

The 2^N corners of the sub-grid around the requested parameters combine
in one weighted sum of corner images on the grid's device (VIP's
per-pixel ``map_coordinates`` loop of order 1 computes the same
multilinear combination)."""

import numpy as np
import torch

from ..config.device import as_tensor
from .utils_negfc import find_nearest

__all__ = ["interpolate_model"]


def interpolate_model(params, grid_param_list, model_grid, interp_order=-1,
                      multispectral=False, verbose=False):
    """Interpolate a model grid at the requested parameters (vip_tpu
    negfd_interp.py:16). ``interp_order`` per dimension: -1 linear in log
    space, 0 nearest neighbour, 1 linear. Returns a tensor on the grid's
    device (numpy grids: the port's device)."""
    model_grid = as_tensor(model_grid)
    n_params_tot = len(grid_param_list)
    if isinstance(interp_order, (int, bool)):
        interp_order = tuple([interp_order] * n_params_tot)

    if np.sum(np.abs(interp_order)) == 0:
        idx_tmp = tuple(find_nearest(grid_param_list[nn], params[nn],
                                     output="index")
                        for nn in range(n_params_tot))
        return model_grid[idx_tmp]

    if len(interp_order) != n_params_tot:
        raise TypeError("if a tuple, interp_order should have same length "
                        "as the number of grid dimensions")
    for i in range(n_params_tot):
        if interp_order[i] not in [-1, 0, 1]:
            raise TypeError("interp_order values should be -1, 0, or 1")

    ndim = 3 if multispectral else 2
    if verbose:
        print("Computing new coords for interpolation")
    constr = ["floor=", "ceil="]
    new_coords = np.zeros(n_params_tot)
    sub_grid_param = np.zeros([n_params_tot, 2])
    subgrid_idx = np.zeros([n_params_tot, 2], dtype=np.int32)
    for nn in range(n_params_tot):
        grid_tmp = np.asarray(grid_param_list[nn])
        params_tmp = params[nn]
        for ii in range(2):
            sub_grid_param[nn, ii] = find_nearest(grid_tmp, params_tmp,
                                                  constraint=constr[ii],
                                                  output="value")
            subgrid_idx[nn, ii] = find_nearest(grid_tmp, params_tmp,
                                               constraint=constr[ii],
                                               output="index")
        if sub_grid_param[nn, 1] == sub_grid_param[nn, 0]:
            new_coords[nn] = 0.0         # on a grid node
        elif interp_order[nn] == -1:
            num = np.log(params_tmp / sub_grid_param[nn, 0])
            denom = np.log(sub_grid_param[nn, 1] / sub_grid_param[nn, 0])
            new_coords[nn] = num / denom
        else:
            num = params_tmp - sub_grid_param[nn, 0]
            denom = sub_grid_param[nn, 1] - sub_grid_param[nn, 0]
            new_coords[nn] = num / denom
        if interp_order[nn] == 0:
            new_coords[nn] = round(new_coords[nn])

    if verbose:
        print("Making sub-grid of models")
    # corner b weighs prod_n (c_n if b_n else 1 - c_n)
    model = torch.zeros(model_grid.shape[-ndim:], dtype=model_grid.dtype,
                        device=model_grid.device)
    for dd in range(2 ** n_params_tot):
        w = 1.0
        idx_tmp = []
        for nn in range(n_params_tot):
            bit = (dd >> (n_params_tot - 1 - nn)) & 1
            idx_tmp.append(int(subgrid_idx[nn, bit]))
            w *= new_coords[nn] if bit else (1.0 - new_coords[nn])
        if w != 0.0:
            model += w * model_grid[tuple(idx_tmp)]
    return model

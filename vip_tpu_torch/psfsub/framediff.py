"""Pairwise frame differencing (port of ``vip_tpu.psfsub.framediff``).

For each annulus: the frame-to-frame distances of the annulus pixels on
the cube's device (optionally after ``pca_annulus``), the PA filter and
the percentile threshold on the host in float64, then each frame minus
its most similar frame (or minus the median of its ``n_similar`` most
similar frames) on the device; the differences are derotated by
``cube_derotate`` (H2 on a float32 card cube) and collapsed by
``cube_collapse`` (H1 for the median). The annuli's frames are summed.
"""

from dataclasses import dataclass
from enum import Enum
from typing import List

import numpy as np
import torch

from ..config import Collapse, Imlib, Interpolation, Metric, time_ini, timing
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..ops.median import nanmedian_plain
from ..preproc.derotation import (_define_annuli, _find_indices_adi,
                                  cube_derotate)
from ..preproc.parangles import check_pa_vector
from ..preproc.subsampling import cube_collapse
from ..var.shapes import get_annulus_segments
from .loci import pairwise_distances
from .pca_fullfr import _value
from .utils_pca import pca_annulus

__all__ = ["frame_diff", "FRAME_DIFF_Params"]


@dataclass
class FRAME_DIFF_Params:
    """Parameters of ``frame_diff`` (vip_tpu framediff.py:32). Arrays may
    be numpy arrays or tensors."""

    cube: object = None
    angle_list: object = None
    fwhm: float = 4
    metric: Enum = Metric.MANHATTAN
    dist_threshold: int = 50
    n_similar: int = None
    delta_rot: float = 0.5
    radius_int: int = 2
    asize: int = 4
    ncomp: int = None
    imlib: Enum = Imlib.VIPFFT
    interpolation: Enum = Interpolation.LANCZOS4
    collapse: Enum = Collapse.MEDIAN
    nproc: int = 1
    verbose: bool = True
    debug: bool = False
    full_output: bool = False


def frame_diff(*all_args: List, **all_kwargs: dict):
    """Pairwise subtraction of the most similar frames in each annulus
    (vip_tpu framediff.py:53). Returns the final frame, a tensor on the
    cube's device."""
    algo_params, rot_options = resolve_algo_params(
        FRAME_DIFF_Params, all_args, all_kwargs)
    p = algo_params
    cube = as_tensor(p.cube)
    start_time = time_ini() if p.verbose else None
    y = cube.shape[1]
    if not p.asize < y // 2:
        raise ValueError("asize is too large")
    angle_list = check_pa_vector(p.angle_list)
    n_annuli = int((y / 2 - p.radius_int) / p.asize)
    if p.verbose:
        if p.ncomp is not None:
            print(f"{n_annuli} annuli. Performing annular PCA subtraction "
                  f"with {p.ncomp} PCs and pair-wise subtraction:")
        else:
            print(f"{n_annuli} annuli. Performing pair-wise subtraction:")
    res = [_pairwise_ann(cube, ann, n_annuli, p.fwhm, angle_list,
                         p.delta_rot, str(_value(p.metric)), p.dist_threshold,
                         p.n_similar, p.radius_int, p.asize, p.ncomp,
                         _value(p.imlib), _value(p.interpolation),
                         _value(p.collapse), p.verbose, debug=p.debug,
                         **rot_options)
           for ann in range(n_annuli)]
    final_frame = torch.stack(res).sum(dim=0)
    if p.verbose:
        print("Done processing annuli")
        timing(start_time)
    return final_frame


def _pairwise_ann(cube, ann, n_annuli, fwhm, angles, delta_rot, metric,
                  dist_threshold, n_similar, radius_int, asize, ncomp, imlib,
                  interpolation, collapse, verbose, debug=False,
                  **rot_options):
    """Pairwise subtraction in one annulus (vip_tpu framediff.py:98)."""
    n_frames, y, x = cube.shape
    pa_threshold, in_rad, ann_center = _define_annuli(
        angles, ann, n_annuli, fwhm, radius_int, asize, delta_rot, 1, verbose)
    arrayin = cube if ncomp is None else pca_annulus(
        cube, None, ncomp, asize, ann_center, svd_mode="lapack",
        scaling=None, collapse=None)
    yy, xx = get_annulus_segments((y, x), in_rad, asize, 1)[0]
    pix = torch.as_tensor(yy * x + xx, device=cube.device)
    values = arrayin.reshape(n_frames, -1)[:, pix]

    mat_full = pairwise_distances(values, metric).double().cpu().numpy()
    if pa_threshold > 0:
        mat = np.zeros_like(mat_full)
        for i in range(n_frames):
            ind_fr_i = _find_indices_adi(angles, i, pa_threshold, None, False)
            mat[i][ind_fr_i] = mat_full[i][ind_fr_i]
    else:
        mat = mat_full
    if debug:
        print(f"Done calculating the {metric} distance for annulus "
              f"{ann + 1}")
    threshold = np.percentile(mat[mat != 0], dist_threshold)
    mat[mat > threshold] = np.nan
    mat[mat == 0] = np.nan
    if not mat[~np.isnan(mat)].size > 0:
        raise RuntimeError("No pairs left. Decrease thresholds")
    if debug:
        import matplotlib.pyplot as plt

        plt.figure(figsize=(5, 5))
        plt.imshow(mat, origin="lower", interpolation="nearest")
        plt.colorbar()
        plt.title(f"Thresholded distance matrix, annulus {ann + 1}")
        plt.show()

    dev = cube.device
    if n_similar is not None:
        if n_similar < 3:
            raise ValueError("n_similar must be >= 3 or None")
        rows, picks = [], []
        for i in range(n_frames):
            vector = mat[i]
            if np.nansum(vector) == 0:
                continue
            order = np.argsort(vector)  # NaNs sort to the end
            rows.append(i)
            picks.append(order[~np.isnan(vector[order])][:n_similar])
        # each frame minus the median of its picks, the short lists padded
        # with NaN rows that the median ignores
        index = np.zeros((len(rows), n_similar), np.int64)
        pad = np.ones((len(rows), n_similar), bool)
        for r, pk in enumerate(picks):
            index[r, :len(pk)] = pk
            pad[r, :len(pk)] = False
        similar = values[torch.as_tensor(index, device=dev)]
        similar = similar.masked_fill(
            torch.as_tensor(pad, device=dev)[:, :, None], torch.nan)
        first = torch.as_tensor(rows, device=dev)
        cube_res = values[first] - nanmedian_plain(similar, 1)
        angles_list = angles[rows]
    else:
        pairs = []
        for i in range(n_frames):
            vector = mat[i]
            if np.nansum(vector) == 0:
                continue
            j = int(np.nanargmin(vector))
            pairs.append((i, j))
            pairs.append((j, i))
        pairs = np.array(sorted(pairs, key=lambda t: t[0]), dtype=np.int64)
        angles_list = angles[pairs[:, 0]]
        pairs = torch.as_tensor(pairs, device=dev)
        cube_res = values[pairs[:, 0]] - values[pairs[:, 1]]

    cube_out = torch.zeros((cube_res.shape[0], y * x), dtype=cube.dtype,
                           device=dev)
    cube_out[:, pix] = cube_res
    cube_der = cube_derotate(cube_out.reshape(-1, y, x), angles_list,
                             imlib=imlib, interpolation=interpolation,
                             mask_val=0, **rot_options)
    return cube_collapse(cube_der, collapse)

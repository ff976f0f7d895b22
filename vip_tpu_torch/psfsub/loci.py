"""LOCI, the locally optimized combination of images (port of
``vip_tpu.psfsub.loci``, the 3-d ADI path).

Annuli and segments as in VIP, walked in VIP's reversed order on the
host. For each segment the frame-to-frame distances are computed on the
cube's device (L1, L2, cosine or correlation, as ``scipy.spatial.distance
.cdist``); the (n, n) matrix comes to the host in float64, where the PA
filter and the percentile threshold pick each frame's library exactly as
vip_tpu does. All frames' least-squares solves then run together on the
device (``ops.lsq_solvers.loci_segment_residuals``: 'lstsq', 'nnls' or
'lsq'). The residual cube is derotated by ``cube_derotate`` (H2 on a
float32 card cube) and collapsed by ``cube_collapse`` (H1 for the
median).

The 4-d (ADI+mSDI) paths need ``preproc.rescaling``: a 4-d cube raises
(ROADMAP.md Queue 1, slice 7).
"""

from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple, Union

import numpy as np
import torch

from ..config import (Adimsdi, Collapse, Imlib, Interpolation, Metric,
                      Solver, time_ini, timing)
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..ops.lsq_solvers import loci_segment_residuals
from ..preproc.derotation import (_define_annuli, _find_indices_adi,
                                  cube_derotate)
from ..preproc.parangles import check_pa_vector
from ..preproc.subsampling import cube_collapse
from ..var.shapes import get_annulus_segments, resolve_n_segments
from .pca_fullfr import _value

__all__ = ["xloci", "XLOCI_Params"]

_METRIC_MAP = {
    "manhattan": "cityblock",
    "cityblock": "cityblock",
    "l1": "cityblock",
    "euclidean": "euclidean",
    "l2": "euclidean",
    "cosine": "cosine",
    "correlation": "correlation",
}


def pairwise_distances(values, metric):
    """``scipy.spatial.distance.cdist(values, values, metric)`` on the
    tensor's device, for the metrics of ``_METRIC_MAP`` (its keys or
    values). L2 takes the direct differences, not the Gram expansion."""
    metric = _METRIC_MAP.get(metric, metric)
    if metric == "cityblock":
        return torch.cdist(values, values, p=1)
    if metric == "euclidean":
        return torch.cdist(values, values, p=2,
                           compute_mode="donot_use_mm_for_euclid_dist")
    if metric in ("cosine", "correlation"):
        v = values - values.mean(dim=1, keepdim=True) \
            if metric == "correlation" else values
        u = v / v.norm(dim=1, keepdim=True)
        return (1.0 - u @ u.T).clamp(min=0)
    raise ValueError(f"metric {metric!r} not recognized")


@dataclass
class XLOCI_Params:
    """Parameters of ``xloci`` (vip_tpu loci.py:43). Arrays may be numpy
    arrays or tensors."""

    cube: object = None
    angle_list: object = None
    scale_list: object = None
    fwhm: float = 4
    metric: Enum = Metric.MANHATTAN
    dist_threshold: int = 100
    delta_rot: Union[float, Tuple[float]] = (0.1, 1)
    delta_sep: Union[float, Tuple[float]] = (0.1, 1)
    radius_int: int = 0
    asize: int = 4
    n_segments: int = 4
    nproc: int = 1
    solver: Enum = Solver.LSTSQ
    tol: float = 1e-2
    optim_scale_fact: float = 2
    adimsdi: Enum = Adimsdi.SKIPADI
    imlib: Enum = Imlib.VIPFFT
    interpolation: Enum = Interpolation.LANCZOS4
    collapse: Enum = Collapse.MEDIAN
    verbose: bool = True
    full_output: bool = False


def xloci(*all_args: List, **all_kwargs: dict):
    """LOCI PSF subtraction of a 3-d ADI cube (vip_tpu loci.py:71).
    Returns the final frame, or with ``full_output`` (cube_res, cube_der,
    frame), as tensors on the cube's device."""
    algo_params, rot_options = resolve_algo_params(
        XLOCI_Params, all_args, all_kwargs)
    p = algo_params
    cube = as_tensor(p.cube)
    start_time = time_ini() if p.verbose else None
    if cube.ndim == 4:
        raise NotImplementedError(
            "xloci: 4-d (ADI+mSDI) cubes need preproc.rescaling, which is "
            "not ported yet (ROADMAP.md Queue 1, slice 7)")
    res = _leastsq_adi(
        cube, check_pa_vector(p.angle_list), fwhm=p.fwhm,
        metric=str(_value(p.metric)), dist_threshold=p.dist_threshold,
        delta_rot=p.delta_rot, radius_int=p.radius_int, asize=p.asize,
        n_segments=p.n_segments, nproc=p.nproc,
        solver=str(_value(p.solver)), tol=p.tol,
        optim_scale_fact=p.optim_scale_fact, imlib=_value(p.imlib),
        interpolation=_value(p.interpolation), collapse=_value(p.collapse),
        verbose=p.verbose, full_output=p.full_output, **rot_options)
    if p.verbose:
        timing(start_time)
    return res


def _leastsq_adi(cube, angle_list, fwhm=4, metric="manhattan",
                 dist_threshold=50, delta_rot=0.5, radius_int=0, asize=4,
                 n_segments=4, nproc=1, solver="lstsq", tol=1e-2,
                 optim_scale_fact=1, imlib="vip-fft",
                 interpolation="lanczos4", collapse="median", verbose=True,
                 full_output=False, **rot_options):
    """Least-squares PSF subtraction of every annulus segment, then the
    derotation and the collapse (vip_tpu loci.py:246)."""
    n, y, x = cube.shape
    if not asize < y // 2:
        raise ValueError("asize is too large")
    angle_list = check_pa_vector(angle_list)
    n_annuli = int((y / 2 - radius_int) / asize)
    if verbose:
        print(f"Building {n_annuli} annuli:")
    if isinstance(delta_rot, tuple):
        delta_rot = np.linspace(delta_rot[0], delta_rot[1], num=n_annuli)
    elif isinstance(delta_rot, (int, float)):
        delta_rot = [delta_rot] * n_annuli
    n_segments = resolve_n_segments(n_segments, n_annuli, asize)

    segments = []
    pa_thresholds = []
    for ann in range(n_annuli):
        inner_radius_ann = radius_int + ann * asize
        pa_thresholds.append(_define_annuli(
            angle_list, ann, n_annuli, fwhm, radius_int, asize,
            delta_rot[ann], n_segments[ann], verbose)[0])
        indices = get_annulus_segments((y, x), inner_radius_ann, asize,
                                       n_segments[ann])
        ind_opt = get_annulus_segments((y, x), inner_radius_ann, asize,
                                       n_segments[ann],
                                       optim_scale_fact=optim_scale_fact)
        segments += [(ann, indices[s], ind_opt[s])
                     for s in range(n_segments[ann])]

    if verbose:
        print("Patch-wise least-square combination and subtraction:")
    flat = cube.reshape(n, -1)
    cube_res = torch.zeros_like(cube)
    flat_res = cube_res.view(n, -1)
    for ann, (yy, xx), (yy_o, xx_o) in segments[::-1]:
        pix = torch.as_tensor(yy * x + xx, device=cube.device)
        pix_o = torch.as_tensor(yy_o * x + xx_o, device=cube.device)
        flat_res[:, pix] = _leastsq_patch(
            flat[:, pix], flat[:, pix_o], pa_thresholds[ann], angle_list,
            metric, dist_threshold, solver, tol)

    cube_der = cube_derotate(cube_res, angle_list, imlib, interpolation,
                             nproc=nproc, **rot_options)
    frame = cube_collapse(cube_der, collapse)
    if verbose:
        print("Done processing annuli")
    if full_output:
        return cube_res, cube_der, frame
    return frame


def _leastsq_patch(values, values_opt, pa_threshold, angles, metric,
                   dist_threshold, solver, tol):
    """One segment (vip_tpu loci.py:305): the distance and PA filters pick
    each frame's library, then every frame's least squares on the
    device. Returns the (n, p) residuals."""
    n = values.shape[0]
    if dist_threshold < 100:
        mat_full = pairwise_distances(values, metric).double().cpu().numpy()
    else:
        mat_full = np.ones((n, n))
    if pa_threshold > 0:
        mat = np.zeros_like(mat_full)
        for i in range(n):
            ind_fr_i = _find_indices_adi(angles, i, pa_threshold, None, False)
            mat[i][ind_fr_i] = mat_full[i][ind_fr_i]
    else:
        mat = mat_full
    masks = _library_masks(mat, dist_threshold,
                           "increasing `dist_threshold` or decreasing "
                           "`delta_rot`")
    return loci_segment_residuals(
        values, values_opt, torch.as_tensor(masks, device=values.device),
        tol, solver=solver)


def _library_masks(mat_dists_ann, dist_threshold, hint):
    """Per-frame library masks from the host distance matrix (vip_tpu
    loci.py:358): distances above the ``dist_threshold`` percentile of
    the nonzero ones, and zeros, are out; a frame left with no library
    raises."""
    mat = mat_dists_ann.copy()
    threshold = np.percentile(mat[mat != 0], dist_threshold)
    mat[mat > threshold] = np.nan
    mat[mat == 0] = np.nan
    masks = ~np.isnan(mat)
    if not masks.any(axis=1).all():
        raise RuntimeError("No frames left in the reference set. Try "
                           + hint + ".")
    return masks

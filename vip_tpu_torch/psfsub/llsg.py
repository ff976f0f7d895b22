"""LLSG, the Local Low-rank + Sparse + Gaussian-noise decomposition
([GOM16]; port of ``vip_tpu.psfsub.llsg``).

Each annulus segment runs the GoDec-style alternation on the cube's
device: project the running estimate on a rank-k subspace (SVD, or a
bilateral random projection), shrink what the projection left into the
sparse term, carry the rest forward. The host keeps the control loop and
the random draws: ``np.random.RandomState(random_seed)`` as in vip_tpu, so
the draws are the same numbers; the QR and the SVDs run on the device.
The sparse term is derotated by ``cube_derotate`` (H2 on a float32 card
cube) and collapsed by ``cube_collapse`` (H1 for the median). With
``high_pass`` the decomposition runs on the cube high-pass filtered as in
vip_tpu: a 19-px median subtracted, then the 'laplacian-conv' kernel of
that size (``var.filters.cube_filter_highpass``).
"""

from dataclasses import dataclass
from enum import Enum
from typing import List

import numpy as np
import torch

from ..config import (AutoRankMode, Collapse, LowRankMode, ThreshMode,
                      time_ini, timing)
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..preproc.derotation import cube_derotate
from ..preproc.subsampling import cube_collapse
from ..var.filters import cube_filter_highpass
from ..var.shapes import get_annulus_segments, resolve_n_segments
from .nmf_fullfr import median_all
from .pca_fullfr import _value
from .svd import get_eigenvectors, svd_wrapper

__all__ = ["llsg", "thresholding", "LLSG_Params"]


def _mad(x):
    """astropy's unscaled median absolute deviation of all values."""
    x = as_tensor(x)
    return median_all((x - median_all(x)).abs())


@dataclass
class LLSG_Params:
    """Parameters of ``llsg`` (vip_tpu llsg.py:35). Arrays may be numpy
    arrays or tensors."""

    cube: object = None
    angle_list: object = None
    fwhm: float = None
    rank: int = 10
    thresh: float = 1
    max_iter: int = 10
    low_rank_ref: bool = False
    low_rank_mode: Enum = LowRankMode.SVD
    auto_rank_mode: Enum = AutoRankMode.NOISE
    residuals_tol: float = 1e-1
    cevr: float = 0.9
    thresh_mode: Enum = ThreshMode.SOFT
    nproc: int = 1
    asize: int = None
    n_segments: int = 4
    azimuth_overlap: int = None
    radius_int: int = None
    random_seed: int = None
    high_pass: int = None
    collapse: Enum = Collapse.MEDIAN
    full_output: bool = False
    verbose: bool = True
    debug: bool = False


def llsg(*all_args: List, **all_kwargs: dict):
    """LLSG decomposition of an ADI cube (vip_tpu llsg.py:69). Returns the
    final frame of the sparse term, or with ``full_output`` the derotated
    cubes and frames of the low-rank, sparse and noise terms (each cube a
    list, one per azimuth rotation), as tensors on the cube's device."""
    algo_params, rot_options = resolve_algo_params(
        LLSG_Params, all_args, all_kwargs)
    p = algo_params

    cube = as_tensor(p.cube)
    if cube.ndim != 3:
        raise TypeError("Input array is not a cube (3d array)")
    if len(p.angle_list) != cube.shape[0]:
        raise TypeError("Angle list vector has wrong length. It must equal "
                        "the number frames in the cube")
    low_rank_mode = str(_value(p.low_rank_mode))
    if low_rank_mode == "brp":
        if p.rank is None:
            raise ValueError("Auto rank only works with SVD low_rank_mode. "
                             "Set a value for the rank parameter")
        if p.low_rank_ref:
            raise ValueError("Low_rank_ref only works with SVD "
                             "low_rank_mode")
    cube_init = cube
    if p.high_pass is not None:
        cube_init = cube_filter_highpass(cube, "median-subt", median_size=19,
                                         verbose=False)
        cube_init = cube_filter_highpass(cube_init, "laplacian-conv",
                                         kernel_size=p.high_pass,
                                         verbose=False)

    start_time = time_ini() if p.verbose else None
    n, y, x = cube.shape
    radius_int = p.radius_int or 0
    annulus_width = int(np.ceil(2 * p.fwhm)) if p.asize is None \
        else int(p.asize)
    n_annuli = int((y / 2 - radius_int) / annulus_width)
    n_segments = resolve_n_segments(p.n_segments, n_annuli, annulus_width,
                                    default=4)
    if p.verbose:
        print(f"Annuli = {n_annuli}")
    azimuth_overlap = p.azimuth_overlap or 360
    n_rots = int(360 / azimuth_overlap)

    # one accumulator plane per decomposition term and azimuth rotation
    n_terms = 3 if p.full_output else 1
    terms = torch.zeros((n_terms, n_rots, n, y * x), dtype=cube.dtype,
                        device=cube.device)
    flat = cube_init.reshape(n, -1)
    opts = dict(thresh_mode=str(_value(p.thresh_mode)),
                auto_rank_mode=str(_value(p.auto_rank_mode)))
    if p.verbose:
        print("Processing annulus: ")
    for ann in range(n_annuli):
        inner_radius = radius_int + ann * annulus_width
        n_segments_ann = n_segments[ann]
        if p.verbose:
            print(f"{ann + 1} : in_rad={inner_radius}, "
                  f"n_segm={n_segments_ann}")
        for i in range(n_rots):
            indices = get_annulus_segments((y, x), inner_radius,
                                           annulus_width, n_segments_ann,
                                           i * azimuth_overlap)
            pix = [torch.as_tensor(yy * x + xx, device=cube.device)
                   for yy, xx in indices]
            for j in range(n_segments_ann):
                data_ref = flat[:, torch.cat([pix[m] for m in
                                              range(n_segments_ann)
                                              if m != j])] \
                    if p.low_rank_ref else None
                patch = _patch_rlrps(
                    flat[:, pix[j]], data_ref, p.rank, p.low_rank_ref,
                    low_rank_mode, p.thresh, opts["thresh_mode"],
                    p.max_iter, opts["auto_rank_mode"], p.cevr,
                    p.residuals_tol, p.random_seed, debug=p.debug,
                    full_output=p.full_output)
                for term, values in enumerate(
                        patch if p.full_output else [patch]):
                    terms[term, i][:, pix[j]] = values.T

    def derot_collapse(mat):
        ders = [cube_derotate(mat[k].reshape(n, y, x), p.angle_list,
                              nproc=p.nproc, **rot_options)
                for k in range(n_rots)]
        frames = torch.stack([cube_collapse(d, mode=_value(p.collapse))
                              for d in ders])
        return ders, cube_collapse(frames, mode=_value(p.collapse))

    derotated = [derot_collapse(terms[t]) for t in range(n_terms)]
    if p.verbose:
        print("")
        timing(start_time)
    if p.full_output:
        (ders_l, frame_l), (ders_s, frame_s), (ders_g, frame_g) = derotated
        return ders_l, ders_s, ders_g, frame_l, frame_s, frame_g
    return derotated[0][1]


def _patch_rlrps(array, array_ref, rank, low_rank_ref, low_rank_mode, thresh,
                 thresh_mode, max_iter, auto_rank_mode="noise", cevr=0.9,
                 residuals_tol=1e-2, random_seed=None, debug=False,
                 full_output=False):
    """GoDec/SSGoDec decomposition of one (n, p) patch (vip_tpu
    llsg.py:193). Returns the sparse term as (p, n), or (low-rank, sparse,
    noise) with ``full_output``."""
    rng = np.random.RandomState(random_seed)
    power = 0

    def low_rank_brp(M):
        # bilateral random projection: the draw on the host, the rest on
        # the device
        sketch = torch.as_tensor(rng.randn(M.shape[1], rank), dtype=M.dtype,
                                 device=M.device)
        for _ in range(power + 1):
            sketch = M.T @ (M @ sketch)
        basis = torch.linalg.qr(sketch, mode="reduced")[0]
        return (M @ basis) @ basis.T

    def low_rank_svd_first(M):
        # the rank chosen on the first pass (CEVR or noise decay)
        pcs = get_eigenvectors(rank, M, "lapack", mode=auto_rank_mode,
                               cevr=cevr, noise_error=residuals_tol,
                               data_ref=(array_ref.T if low_rank_ref
                                         else None),
                               debug=debug, collapse=True,
                               scaling="temp-standard")
        if low_rank_ref:
            return pcs.shape[0], ((pcs @ M).T @ pcs).T
        return pcs.shape[0], (M @ pcs.T) @ pcs

    def low_rank_svd(M):
        k = min(rank, *M.shape)
        pcs = svd_wrapper(M, "lapack", k, False, random_state=rng,
                          to_numpy=False)
        return (M @ pcs.T) @ pcs

    if low_rank_mode not in ("brp", "svd"):
        raise RuntimeError("Low Rank estimation mode not recognized.")

    running = array
    sparse = torch.zeros_like(array)
    for step in range(max_iter + 1):
        if low_rank_mode == "brp":
            lowrank = low_rank_brp(running)
        elif step == 0:
            rank, lowrank = low_rank_svd_first(running)
        else:
            lowrank = low_rank_svd(running)
        leftover = running - lowrank + sparse
        cut = torch.sqrt(_mad(leftover)) * thresh
        if debug:
            print(f"threshold = {float(cut):.3f}")
        sparse = thresholding(leftover, cut, thresh_mode)
        running = lowrank + leftover - sparse

    if full_output:
        noise = array - running - sparse
        return running.T, sparse.T, noise.T
    return sparse.T


def thresholding(array, threshold, mode):
    """Elementwise shrinkage (vip_tpu llsg.py:255): 'soft', 'hard' and
    'nng' act on |x| against the threshold, 'greater' and 'less' clip one
    side. Returns a tensor on the array's device."""
    x = as_tensor(array)
    mag = x.abs()
    if mode == "soft":
        return torch.where(mag <= threshold, 0.0, x - torch.sign(x)
                           * threshold)
    if mode == "hard":
        return torch.where(mag < threshold, 0.0, x)
    if mode == "nng":
        return torch.where(mag <= threshold, 0.0, x - threshold ** 2 / x)
    if mode == "greater":
        return torch.where(x < threshold, 0.0, x)
    if mode == "less":
        return torch.where(x > threshold, 0.0, x)
    raise RuntimeError("Thresholding mode not recognized")

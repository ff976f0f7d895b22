"""Iterative PCA, GreeDS ([PAI21], [CHR24]; port of
``vip_tpu.greedy.ipca_fullfr``).

Repeat ``nit`` times: the port's full-frame ``pca`` (on the cube's
device: H2 derotation, H1 median), the significant signal from the STIM
map, and that signal, rotated into every frame, taken out of the PCA
library. Strategies ADI, RDI, ARDI and RADI; a fixed ncomp (``mode``
None), the incremental 'Christiaens24' schedule, and 'Juillard23' (the
incremental GreeDS loop, :func:`_greeds_native`). The host drives the
iterations. Results are tensors on the cube's device.
"""

import dataclasses
from dataclasses import dataclass
from typing import List, Union

import numpy as np
import torch

from ..config import time_ini, timing
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params
from ..ops.linalg import svd_top
from ..preproc.derotation import cube_derotate
from ..preproc.subsampling import cube_collapse
from ..psfsub.pca_fullfr import PCA_Params, pca
from ..psfsub.rollsub import _host_angles
from ..var.filters import frame_filter_lowpass
from ..var.shapes import mask_circle, prepare_matrix
from .utils_greedy import blurring_3d, find_significant_signals

__all__ = ["ipca", "IPCA_Params"]


def _repeat(frame, n):
    return frame[None].expand(n, -1, -1).contiguous()


def _greeds_native(cube, angles, ncomp, nit, ncomp_start=1, pup=0,
                   refs=None, imlib="vip-fft", nproc=1, keep_l="last"):
    """The GreeDS loop ([PAI21] alg. 1, as [JUI23] packages it; vip_tpu
    ipca_fullfr.py:30): for each rank from ``ncomp_start`` to ``ncomp``,
    ``nit`` times, rotate the disk estimate into every frame, take it out,
    fit a rank-r model of that cube, take the model out of the raw cube,
    derotate, take the mean and keep its positive part. Returns the
    estimate after every iteration (stacked) and the speckle models (the
    last one, or all with ``keep_l="all"``)."""
    if nit < 1 or ncomp < ncomp_start:
        raise ValueError("GreeDS needs nit >= 1 and ncomp >= ncomp_start "
                         f"(got nit={nit}, ncomp={ncomp}, "
                         f"ncomp_start={ncomp_start})")
    t = cube.shape[0]
    estimate = torch.zeros(cube.shape[1:], dtype=cube.dtype,
                           device=cube.device)
    it_frames, star_estim = [], []
    for rank in range(ncomp_start, ncomp + 1):
        for _ in range(nit):
            est_rot = cube_derotate(_repeat(estimate, t), -angles,
                                    imlib=imlib, nproc=nproc)
            speckle_only = (cube - est_rot).reshape(t, -1)
            lib = speckle_only if refs is None else torch.cat(
                [speckle_only, refs.reshape(refs.shape[0], -1)])
            basis = svd_top(lib, rank, method="lapack")
            model = ((speckle_only @ basis.T) @ basis).reshape(cube.shape)
            derot = cube_derotate(cube - model, angles, imlib=imlib,
                                  nproc=nproc)
            frame = derot.mean(dim=0)
            estimate = torch.where(frame > 0, frame, 0.0)
            if pup:
                estimate = mask_circle(estimate, pup)
            it_frames.append(estimate.clone())
            if keep_l == "all":
                star_estim.append(model)
    if keep_l != "all":
        star_estim.append(model)
    return torch.stack(it_frames), star_estim


def _ipca_juillard23(p, start_time):
    """``mode='Juillard23'``: the incremental GreeDS loop, its outputs
    assembled as VIP does (vip_tpu ipca_fullfr.py:85)."""
    if p.strategy not in ("ADI", "ARDI"):
        raise RuntimeError("Juillard23 not compatible with this mode.")
    cube = as_tensor(p.cube)
    refs = as_tensor(p.cube_ref, cube.device, cube.dtype) \
        if p.strategy == "ARDI" else None
    angles = _host_angles(p.angle_list)
    full = bool(p.full_output)
    it_cube, star_estim = _greeds_native(
        cube, angles, ncomp=int(p.ncomp), nit=int(p.nit),
        ncomp_start=int(p.ncomp_start), pup=p.mask_center_px or 0,
        refs=refs, imlib=p.imlib, nproc=p.nproc,
        keep_l="all" if full else "last")
    frame = it_cube[-1]
    if p.verbose:
        timing(start_time)
    if not full:
        return frame

    def drot(c, sign=1):
        return cube_derotate(c, sign * angles, imlib=p.imlib, nproc=p.nproc)

    residuals_cube_ = drot(cube - star_estim[-1]) - frame
    residuals_cube = drot(residuals_cube_, -1)
    if p.thr_mode == "STIM":
        sig_mask = torch.zeros_like(it_cube)
        nstim = torch.zeros_like(it_cube)
        for i in range(len(it_cube)):
            res_der_i = drot(cube - star_estim[i]) - it_cube[i]
            sig_mask[i], nstim[i] = find_significant_signals(
                drot(res_der_i, -1), res_der_i, angles, p.thr,
                mask=p.mask_center_px, r_out=p.r_out)
    else:
        sig_mask = (it_cube >= p.thr).to(it_cube.dtype)
        nstim = sig_mask.clone()
    sig_images = torch.where(sig_mask > 0, it_cube, 0.0).clamp(min=0)
    return (frame, it_cube, sig_images, residuals_cube, residuals_cube_,
            nstim, torch.zeros_like(it_cube))


@dataclass
class IPCA_Params(PCA_Params):
    """Parameters of ``ipca`` (vip_tpu ipca_fullfr.py:140)."""

    mode: str = None
    strategy: str = "ADI"
    ncomp_start: int = 1
    ncomp_step: int = 1
    nit: int = 1
    thr: Union[float, str] = 0.0
    thr_mode: str = "STIM"
    r_out: float = None
    r_max: float = None
    smooth_ker: Union[float, List, np.ndarray] = None
    rtol: float = 1e-2
    atol: float = 1e-2
    continue_without_smooth_after_conv: bool = False
    add_nd_excess: bool = False


def ipca(*all_args: List, **all_kwargs: dict):
    """Iterative PCA (vip_tpu ipca_fullfr.py:160). Returns the final
    frame, or with ``full_output`` (frame, it_cube, sig_images,
    residuals_cube, residuals_cube_, stim_cube, it_cube_nd), as tensors
    on the cube's device."""
    algo_params, rot_options = resolve_algo_params(
        IPCA_Params, all_args, all_kwargs)
    p = algo_params
    # the inner pca's keywords come from the resolved parameters, so that
    # positional arguments reach it too
    pca_fields = {f.name for f in dataclasses.fields(PCA_Params)}
    pca_params = {f.name: getattr(p, f.name)
                  for f in dataclasses.fields(IPCA_Params)
                  if f.name in pca_fields and getattr(p, f.name) is not None}
    start_time = time_ini(p.verbose)
    pca_params["full_output"] = True
    pca_params["verbose"] = False

    if p.mode == "Juillard23":
        return _ipca_juillard23(p, start_time)
    if p.mask_rdi is not None and p.mode is not None:
        raise TypeError("IPCA with data imputation is not compatible with "
                        "incremental mode. Set 'mode' to None.")

    cube = as_tensor(p.cube)
    dev, dt = cube.device, cube.dtype
    angles = _host_angles(p.angle_list)
    cube_ref = None if p.cube_ref is None else as_tensor(p.cube_ref, dev, dt)
    mask_center_px = p.mask_center_px
    mask_rdi_tmp = None
    if p.strategy == "ADI" and cube_ref is None:
        ref_cube = None
        mask_rdi_tmp = p.mask_rdi
    elif cube_ref is not None:
        if p.strategy == "ADI":
            print("WARNING: requested strategy is 'ADI' but reference cube "
                  "detected! Strategy automatically switched to 'ARDI'.")
            p.strategy = "ARDI"
        if p.mask_rdi is not None:
            mask_rdi_tmp = p.mask_rdi
        if p.strategy == "ARDI" and p.mask_rdi is None:
            ref_cube = torch.cat((cube, cube_ref))
        else:
            ref_cube = cube_ref
    else:
        raise ValueError("strategy not recognized: must be ADI, RDI, ARDI "
                         "or RADI")

    cond_di = p.mask_rdi is not None
    if isinstance(p.ncomp, (float, int)):
        ncomp_list = [p.ncomp]
        if cond_di:
            ncomp_list.append(p.ncomp)
        if p.strategy == "RADI":
            ncomp_list.append(p.ncomp)
    elif isinstance(p.ncomp, (tuple, list)):
        ncomp_list = list(p.ncomp)
    else:
        raise TypeError("ncomp should be float, int, tuple or list")

    ncomp_tmp = ncomp_list[0]
    nframes = cube.shape[0]
    nit_ori = p.nit
    if p.mode is not None:
        if p.mode != "Christiaens24":
            raise ValueError("mode is not recognized.")
        final_ncomp = [npc for npc in range(p.ncomp_start, ncomp_tmp + 1,
                                            p.ncomp_step)
                       for _ in range(p.nit)]
        p.nit = len(final_ncomp)
    else:
        final_ncomp = [ncomp_tmp] * p.nit
        if cond_di:
            final_ncomp = [ncomp_tmp] + [ncomp_list[1]] * (p.nit - 1)

    def prepared(c):
        return prepare_matrix(c, scaling=p.scaling,
                              mask_center_px=mask_center_px, mode="fullfr",
                              verbose=False).reshape(c.shape)

    cube_tmp = prepared(cube)
    cube_ref_tmp = None if ref_cube is None else prepared(ref_cube)

    # first iteration
    pca_params.update(ncomp=final_ncomp[0], cube=cube_tmp,
                      cube_ref=cube_ref_tmp, mask_rdi=mask_rdi_tmp)
    res = pca(**pca_params, **rot_options)
    frame, residuals_cube, residuals_cube_ = res[0], res[-2], res[-1]

    smooth_ker = p.smooth_ker
    if smooth_ker is None or np.isscalar(smooth_ker):
        smooth_ker = [smooth_ker] * p.nit
    else:
        smooth_ker = list(smooth_ker)
        if len(smooth_ker) != p.nit:
            raise TypeError("If a 1d array or list, smooth_ker should have "
                            "nit length")
    if smooth_ker[0] is not None:
        if np.isscalar(smooth_ker[0]):
            frame = frame_filter_lowpass(frame, fwhm_size=smooth_ker[0])
        else:
            frame = frame_filter_lowpass(frame, mode="psf",
                                         psf=smooth_ker[0])

    it_cube = torch.zeros((p.nit,) + tuple(frame.shape), dtype=dt, device=dev)
    it_cube_nd = torch.zeros_like(it_cube)
    stim_cube = torch.zeros_like(it_cube)
    sig_images = torch.zeros_like(it_cube)
    it_cube[0] = frame
    it_cube_nd[0] = frame
    if p.thr_mode == "STIM":
        sig_mask, nstim = find_significant_signals(
            residuals_cube, residuals_cube_, angles, p.thr,
            mask=mask_center_px, r_out=p.r_out)
    else:
        sig_mask = (frame >= p.thr).to(dt)
        nstim = sig_mask.clone()
    sig_image = torch.where(sig_mask.bool(), frame, 0.0).clamp(min=0)
    sig_images[0] = sig_image
    stim_cube[0] = nstim
    mask_rdi_tmp = None
    frame_nd = frame

    it = 0
    for it in range(1, p.nit):
        # the current signal estimate in each frame's orientation
        sig_cube = cube_derotate(_repeat(frame, nframes), -angles,
                                 imlib=p.imlib, nproc=p.nproc)
        if p.thr_mode == "STIM":
            sig_mcube = cube_derotate(
                _repeat((sig_image > 0).to(dt), nframes), -angles,
                imlib="skimage", interpolation="bilinear", nproc=p.nproc)
            sig_cube = torch.where(sig_mcube < 0.5, 0.0, sig_cube)
            sig_cube = sig_cube.clamp(min=0)
        else:
            sig_cube = torch.where(sig_cube < p.thr, 0.0, sig_cube)

        if p.strategy == "ARDI":
            ref_cube = torch.cat((cube - sig_cube, cube_ref))
            cube_ref_tmp = prepared(ref_cube)

        # PCA with the signal taken out of the library
        pca_params.update(cube=cube,
                          cube_ref=None if p.strategy == "ADI" else ref_cube,
                          ncomp=final_ncomp[it], scaling=p.scaling,
                          cube_sig=sig_cube, mask_rdi=mask_rdi_tmp)
        res = pca(**pca_params, **rot_options)
        frame, residuals_cube = res[0], res[-2]
        # as vip_tpu (and VIP, ipca_fullfr.py:730-734): residuals_cube_ is
        # not refreshed here
        it_cube[it] = frame

        # PCA of the cube without the disk, for the STIM normalization
        pca_params.update(cube=cube_tmp - sig_cube, cube_ref=cube_ref_tmp,
                          cube_sig=None, scaling=None)
        res_nd = pca(**pca_params, **rot_options)
        residuals_cube_nd, frame_nd = res_nd[-2], res_nd[0]

        if smooth_ker[it] is not None:
            residuals_cube = blurring_3d(residuals_cube, None,
                                         fwhm_sz=smooth_ker[it])
            residuals_cube_ = cube_derotate(residuals_cube, angles,
                                            imlib=p.imlib, nproc=p.nproc)
            frame = cube_collapse(residuals_cube_, p.collapse)
            residuals_cube_nd = blurring_3d(residuals_cube_nd, None,
                                            fwhm_sz=smooth_ker[it])
            frame_nd = cube_collapse(
                cube_derotate(residuals_cube_nd, angles, imlib=p.imlib,
                              nproc=p.nproc), p.collapse)

        if p.add_nd_excess and p.thr_mode != "STIM":
            frame = frame + frame_nd * (frame_nd >= p.thr).to(dt)

        if p.thr_mode == "STIM":
            sig_mask, nstim = find_significant_signals(
                residuals_cube_nd, residuals_cube_, angles, p.thr,
                mask=mask_center_px, r_out=p.r_out)
        else:
            sig_mask = (frame >= p.thr).to(dt)
            nstim = sig_mask.clone()
        inv_sig_mask = 1.0 - sig_mask
        if mask_center_px:
            inv_sig_mask = mask_circle(inv_sig_mask, mask_center_px,
                                       fillwith=1)
        sig_image = torch.where(inv_sig_mask.bool(), 0.0, frame).clamp(min=0)

        it_cube[it] = frame
        it_cube_nd[it] = frame_nd
        sig_images[it] = sig_image
        stim_cube[it] = nstim

        # convergence
        if it > 1:
            cond1 = torch.allclose(sig_image, sig_images[it - 1],
                                   rtol=p.rtol, atol=p.atol)
            cond2 = torch.allclose(sig_image, sig_images[it - 2],
                                   rtol=p.rtol, atol=p.atol)
            if cond1 or cond2:
                if p.mode == "Christiaens24" and (it % nit_ori
                                                  != nit_ori - 1):
                    continue
                if p.strategy in ["ADI", "RDI", "ARDI"]:
                    if smooth_ker[it] is not None \
                            and p.continue_without_smooth_after_conv:
                        for k in range(it + 1, p.nit):
                            smooth_ker[k] = None
                        if p.verbose:
                            print(f"Convergence after {it} iterations. "
                                  "Switching smoothing off and iterating!")
                    else:
                        if p.verbose:
                            print(f"Final convergence criterion met after "
                                  f"{it} iterations.")
                        break
                elif p.strategy == "RADI":
                    final_ncomp = [ncomp_list[1]] * p.nit
                    p.strategy = "ADI"
                    ref_cube = None
                    cube_ref_tmp = None
                    if p.verbose:
                        print(f" After {it} iterations, PCA-RDI -> PCA-ADI.")

    if mask_center_px is not None:
        frame = mask_circle(frame, mask_center_px)
        it_cube = mask_circle(it_cube, mask_center_px)
        residuals_cube = mask_circle(residuals_cube, mask_center_px)
        residuals_cube_ = mask_circle(residuals_cube_, mask_center_px)
        it_cube_nd = mask_circle(it_cube_nd, mask_center_px)
    if p.verbose:
        timing(start_time)
    if p.full_output:
        return (frame, it_cube[:it + 1], sig_images[:it + 1], residuals_cube,
                residuals_cube_, stim_cube[:it + 1], it_cube_nd[:it + 1])
    return frame

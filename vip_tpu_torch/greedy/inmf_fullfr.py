"""Iterative NMF (port of ``vip_tpu.greedy.inmf_fullfr``): the greedy
pattern of ``ipca`` with the port's full-frame ``nmf`` as the inner step,
and the incremental-ncomp schedules 'Pairet18', 'Pairet21' and
'Christiaens21'. The host drives the iterations; results are tensors on
the cube's device."""

from dataclasses import dataclass
from typing import List, Union

import numpy as np
import torch

from ..config import time_ini, timing
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params, separate_kwargs_dict
from ..preproc.derotation import cube_derotate
from ..preproc.subsampling import cube_collapse
from ..psfsub.nmf_fullfr import NMF_Params, nmf
from ..psfsub.rollsub import _host_angles
from ..var.shapes import mask_circle, prepare_matrix
from .ipca_fullfr import _repeat
from .utils_greedy import blurring_2d, blurring_3d, find_significant_signals

__all__ = ["inmf", "INMF_Params"]


@dataclass
class INMF_Params(NMF_Params):
    """Parameters of ``inmf`` (vip_tpu inmf_fullfr.py:23)."""

    mode: str = None
    strategy: str = "ADI"
    ncomp_step: int = 1
    nit: int = 1
    thr: Union[float, str] = 0.0
    thr_mode: str = "STIM"
    r_out: float = None
    r_max: float = None
    smooth_ker: Union[float, List, np.ndarray] = 1.0
    rtol: float = 1e-2
    atol: float = 1e-2
    continue_without_smooth_after_conv: bool = False
    mask_rdi: object = None
    imlib: str = "vip-fft"
    nproc: int = 1


def _schedule(p, ncomp_tmp):
    """The ncomp of every iteration (vip_tpu inmf_fullfr.py:100-125); sets
    ``p.nit`` (and ``p.thr`` for the Pairet modes) as vip_tpu does."""
    if p.mode is None:
        return [ncomp_tmp] * p.nit
    steps = list(range(1, ncomp_tmp + 1, p.ncomp_step))
    if p.mode == "Pairet18":
        final_ncomp = steps
        p.thr = 0
    elif p.mode in ("Pairet21", "Christiaens21"):
        final_ncomp = [npc for npc in steps for _ in range(p.nit)]
        if p.mode == "Pairet21":
            p.thr = 0
    else:
        # any other mode: the plain incremental schedule, padded with the
        # last ncomp so that a larger nit does not run past it
        final_ncomp = steps
        if p.nit > len(final_ncomp):
            final_ncomp += [final_ncomp[-1]] * (p.nit - len(final_ncomp))
        else:
            final_ncomp = final_ncomp[:max(1, p.nit)]
    p.nit = len(final_ncomp)
    return final_ncomp


def inmf(*all_args: List, **all_kwargs: dict):
    """Iterative NMF (vip_tpu inmf_fullfr.py:45). Returns the final frame,
    or with ``full_output`` (frame, it_cube, sig_images, residuals_cube,
    residuals_cube_, stim_cube, it_cube_nd), as tensors on the cube's
    device."""
    algo_params, rot_options = resolve_algo_params(
        INMF_Params, all_args, all_kwargs)
    p = algo_params
    nmf_params, _ = separate_kwargs_dict(
        initial_kwargs=separate_kwargs_dict(all_kwargs, INMF_Params)[0],
        parent_class=NMF_Params)
    start_time = time_ini(p.verbose)
    nmf_params["full_output"] = True
    nmf_params["verbose"] = False

    cube = as_tensor(p.cube)
    dev, dt = cube.device, cube.dtype
    angles = _host_angles(p.angle_list)
    mask_center_px = p.mask_center_px
    mask_rdi_tmp = None
    if p.strategy == "ADI":
        ref_cube = None
        mask_rdi_tmp = p.mask_rdi
    elif p.strategy in ["RDI", "ARDI", "RADI"]:
        if p.mask_rdi is not None:
            mask_rdi_tmp = p.mask_rdi
        if p.cube_ref is None:
            raise ValueError("cube_ref should be provided for RDI or RADI")
        cube_ref = as_tensor(p.cube_ref, dev, dt)
        ref_cube = torch.cat((cube, cube_ref)) if p.strategy == "ARDI" \
            else cube_ref
    else:
        raise ValueError("strategy not recognized: must be ADI, RDI, ARDI "
                         "or RADI")

    if isinstance(p.ncomp, (float, int)):
        ncomp_list = [p.ncomp]
        if p.strategy == "RADI":
            ncomp_list.append(p.ncomp)
    elif isinstance(p.ncomp, (tuple, list)):
        ncomp_list = list(p.ncomp)
        if len(ncomp_list) == 1:
            if p.strategy == "RADI":
                ncomp_list.append(ncomp_list[0])
        elif len(ncomp_list) != 2:
            raise ValueError("Length of npc list cannot be larger than 2")
    else:
        raise TypeError("ncomp should be float, int, tuple or list")
    nframes = cube.shape[0]
    final_ncomp = _schedule(p, ncomp_list[0])

    def prepared(c):
        return prepare_matrix(c, scaling=p.scaling,
                              mask_center_px=mask_center_px, mode="fullfr",
                              verbose=False).reshape(c.shape)

    cube_tmp = prepared(cube)
    cube_ref_tmp = None if ref_cube is None else prepared(ref_cube)

    # first iteration
    nmf_params.update(cube=cube.clamp(min=0), cube_ref=ref_cube,
                      ncomp=final_ncomp[0])
    res = nmf(**nmf_params, **rot_options)
    frame, residuals_cube, residuals_cube_ = res[-1], res[-3], res[-2]

    smooth_ker = p.smooth_ker
    if smooth_ker is None or np.isscalar(smooth_ker):
        smooth_ker = np.array([smooth_ker] * p.nit, dtype=object)
    else:
        smooth_ker = np.array(smooth_ker, dtype=object)
    if smooth_ker[0] is not None:
        residuals_cube = blurring_3d(residuals_cube, None,
                                     fwhm_sz=smooth_ker[0])
        residuals_cube_ = cube_derotate(residuals_cube, angles,
                                        imlib=p.imlib, nproc=p.nproc)
        frame = cube_collapse(residuals_cube_, p.collapse)

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
    sig_image = torch.where(sig_mask.bool(), frame.clamp(min=0), 0.0)
    sig_images[0] = sig_image
    stim_cube[0] = nstim
    mask_rdi_tmp = None
    frame_nd = frame

    it = 0
    for it in range(1, p.nit):
        if smooth_ker[it] is not None:
            frame = blurring_2d(frame, None, fwhm_sz=smooth_ker[it])
        sig_cube = cube_derotate(_repeat(frame, nframes), -angles,
                                 imlib=p.imlib, nproc=p.nproc)
        if p.thr_mode == "STIM":
            sig_mcube = cube_derotate(
                _repeat((sig_image > 0).to(dt), nframes), -angles,
                imlib="skimage", interpolation="bilinear", nproc=p.nproc)
            sig_cube = torch.where((sig_mcube < 0.5) | (sig_cube < 0), 0.0,
                                   sig_cube)
        else:
            sig_cube = torch.where(sig_cube < p.thr, 0.0, sig_cube)

        if p.strategy == "ARDI":
            ref_cube = torch.cat((cube - sig_cube, cube_ref))
            cube_ref_tmp = prepared(ref_cube)

        nmf_params.update(cube=cube, cube_ref=ref_cube,
                          ncomp=final_ncomp[it], cube_sig=sig_cube)
        if mask_rdi_tmp is not None:
            nmf_params["mask_rdi"] = mask_rdi_tmp
        res = nmf(**nmf_params, **rot_options)
        frame, residuals_cube, residuals_cube_ = res[-1], res[-3], res[-2]
        it_cube[it] = frame

        if smooth_ker[it] is not None:
            residuals_cube = blurring_3d(residuals_cube, None,
                                         fwhm_sz=smooth_ker[it])
            residuals_cube_ = cube_derotate(residuals_cube, angles,
                                            imlib=p.imlib, nproc=p.nproc)
            frame = cube_collapse(residuals_cube_, p.collapse)

        nmf_params.update(cube=(cube_tmp - sig_cube).clamp(min=0),
                          cube_ref=cube_ref_tmp, cube_sig=None)
        res_nd = nmf(**nmf_params, **rot_options)
        residuals_cube_nd, frame_nd = res_nd[-3], res_nd[-1]

        if p.thr_mode == "STIM":
            sig_mask, nstim = find_significant_signals(
                residuals_cube_nd, residuals_cube_, angles, p.thr,
                mask=mask_center_px, r_out=p.r_out)
        else:
            sig_mask = (frame >= p.thr).to(dt)
            nstim = sig_mask.clone()
        inv_sig_mask = torch.where(sig_mask.bool(), 0.0, 1.0).to(dt)
        if mask_center_px:
            inv_sig_mask = mask_circle(inv_sig_mask, mask_center_px,
                                       fillwith=1)
        sig_image = torch.where(inv_sig_mask.bool(), 0.0, frame.clamp(min=0))

        it_cube[it] = frame
        it_cube_nd[it] = frame_nd
        sig_images[it] = sig_image
        stim_cube[it] = nstim

        if it > 1:
            cond1 = torch.allclose(sig_image, sig_images[it - 1],
                                   rtol=p.rtol, atol=p.atol)
            cond2 = torch.allclose(sig_image, sig_images[it - 2],
                                   rtol=p.rtol, atol=p.atol)
            if cond1 or cond2:
                if p.strategy in ["ADI", "RDI", "ARDI"]:
                    if smooth_ker[it] is not None \
                            and p.continue_without_smooth_after_conv:
                        smooth_ker[it + 1:] = None
                        if p.verbose:
                            print(f"Convergence after {it} iterations. "
                                  "Switching smoothing off!")
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
                        print(f" After {it} iterations, NMF-RDI -> NMF-ADI.")

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

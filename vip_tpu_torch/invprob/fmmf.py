"""Forward Model Matched Filter (FMMF), KLIP or LOCI based ([RUF17],
[DAH21a]; port of ``vip_tpu.invprob.fmmf``).

For each annulus: the KLIP (or LOCI) residuals of every frame on the
cube's device, their derotation (``preproc.derotation.cube_derotate``:
CUDA kernel H2 on an even float32 cube on the card), the noise variance,
then for every pixel of the annulus the forward model of a unit
companion there (its over- and self-subtraction by the same KLIP bases
or LOCI coefficients), derotated and matched to the residuals.

The P unit-companion models of an annulus are built in one batch on the
device: one batched sub-pixel shift of the PSF stamp for every (pixel,
frame) pair (``ops.fft.fourier_shift_batch``, the 'vip-fft' shift of
``fm.cube_inject_companions``; 'opencv' and 'skimage' shift them as that
function pairs its imlibs, in one ``cube_shift``) and one indexed add
into the annulus
columns (``ops.negfc_model._place``), where vip_tpu injects a cube a
pixel. Two forms of the per-pixel loop, as in vip_tpu
(``VIP_TPU_FMMF_BATCHED``): the serial one derotates each pixel's n model
frames in its own call; the batched one computes the KLIP perturbation
of all pixels frame by frame as batched matrix products and derotates
the n x P model frames in chunks of pixels under a 2 GiB budget (plus
the derotation's own 8 GiB working set). The default is the serial form
on the CPU, as vip_tpu's, and the batched one on CUDA: on an NVIDIA H100
80GB HBM3 at 700 W one annulus took 0.44-0.52 s batched against 7.8-16.2
s serial on the NACO replica, 1.38 s against 65.7 s at 100x256²
(``chip_smoke.py`` phase 17, PERF.md).
"""

import os
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from ..config import time_ini, timing
from ..config.device import as_tensor
from ..config.paramenum import ALGO_KEY, Imlib, Interpolation, VarEstim
from ..config.utils_param import separate_kwargs_dict
from ..fm.fakecomp import _host
from ..ops.fft import cyclic_fourier_shift, fourier_shift_batch
from ..ops.linalg import svd
from ..ops.negfc_model import _place, _stamp_origin
from ..preproc.cosmetics import cube_crop_frames
from ..preproc.derotation import _find_indices_adi, cube_derotate
from ..var.coords import frame_center
from ..var.shapes import get_annulus_segments

__all__ = ["fmmf", "FMMF_Params"]

#: Bytes of model frames (and as many rotated ones) a derotation call of
#: the batched form takes at a time
_FRAMES_BUDGET = 2 << 30


@dataclass
class FMMF_Params:
    """Parameters of :func:`fmmf` (vip_tpu fmmf.py:31)."""

    cube: np.ndarray = None
    angle_list: np.ndarray = None
    psf: np.ndarray = None
    fwhm: float = None
    min_r: int = None
    max_r: int = None
    model: str = "KLIP"
    var: Enum = VarEstim.FR
    param: dict = field(default_factory=lambda: {
        "ncomp": 20, "tolerance": 5e-3, "delta_rot": 0.5})
    crop: int = 5
    imlib: Enum = Imlib.VIPFFT
    interpolation: Enum = Interpolation.LANCZOS4
    nproc: int = 1
    verbose: bool = True


def fmmf(*all_args, **all_kwargs: dict):
    """FMMF detection maps (vip_tpu fmmf.py:51): the matched filter's flux
    estimate and S/N of every pixel of the annuli min_r..max_r-1. The cube
    runs on its own device (numpy input on the default device). Returns
    (flux_matrix, snr_matrix) as tensors on that device."""
    class_params, other_options = separate_kwargs_dict(
        initial_kwargs=all_kwargs, parent_class=FMMF_Params)
    algo_params = other_options.pop(ALGO_KEY, None)
    if algo_params is None:
        algo_params = FMMF_Params(*all_args, **class_params)
    p = algo_params
    start_time = time_ini(p.verbose)

    if p.crop >= 2 * round(p.fwhm) + 1:
        raise ValueError("Maximum cropsize should be lower or equal to two"
                         " FWHM,please change accordingly the value of "
                         "'crop'")
    cube = as_tensor(p.cube)
    angle_list = _host(p.angle_list)
    psf = _host(p.psf)
    if p.min_r is None:
        p.min_r = int(round(p.fwhm))
    if p.max_r is None:
        p.max_r = cube.shape[-1] // 2 - (p.crop // 2 + 1)

    flux_matrix = torch.zeros(cube.shape[1:], dtype=cube.dtype,
                              device=cube.device)
    snr_matrix = torch.zeros_like(flux_matrix)
    for ann_center in range(p.min_r, p.max_r):
        prob, flux, _ = _snr_contrast_esti(
            ann_center, cube, angle_list, psf, p.fwhm, p.model, p.var,
            p.param, p.crop, p.imlib, p.interpolation, p.verbose)
        (yy, xx), = get_annulus_segments(tuple(cube.shape[1:]), ann_center,
                                         1, 1)
        yy = torch.as_tensor(yy, device=cube.device)
        xx = torch.as_tensor(xx, device=cube.device)
        flux_matrix[yy, xx] = prob
        snr_matrix[yy, xx] = flux
    if p.verbose:
        timing(start_time)
    return flux_matrix, snr_matrix


def _fmmf_batched_enabled(device):
    """The per-pixel form: ``VIP_TPU_FMMF_BATCHED=0/1`` forces the serial
    or the batched one; by default the serial form on the CPU, as
    vip_tpu, and the batched form on CUDA (the module's docstring gives
    the card's timings)."""
    env = os.environ.get("VIP_TPU_FMMF_BATCHED")
    if env is not None:
        return env == "1"
    return torch.device(device).type != "cpu"


def _snr_contrast_esti(ann_center, cube, angle_list, psf, fwhm, model, var,
                       param, crop, imlib, interpolation, verbose):
    """Matched-filter flux estimate and S/N of every pixel of one annulus
    (vip_tpu fmmf.py:87). Returns (prob_esti, flux_esti, ann_center), the
    first two tensors on the cube's device."""
    cube = as_tensor(cube)
    n, y, x = cube.shape
    tolerance = param.get("tolerance", 5e-3)
    delta_rot = param.get("delta_rot", 0.5)
    ncomp = param.get("ncomp", 20)

    pa_threshold = np.rad2deg(2 * np.arctan(delta_rot * fwhm /
                                            (2 * ann_center)))
    mid_range = np.abs(np.amax(angle_list) - np.amin(angle_list)) / 2
    if pa_threshold >= mid_range - mid_range * 0.1:
        pa_threshold = float(mid_range - mid_range * 0.1)

    band = get_annulus_segments((y, x), ann_center - int(round(fwhm) / 2),
                                int(round(fwhm)), 1)[0]
    band_t = tuple(torch.as_tensor(i, device=cube.device) for i in band)
    klip = None
    ind_ref_list = coef_list = None
    if model == "KLIP":
        matrix = cube[:, band_t[0], band_t[1]]
        patches = [KLIP_patch(k, matrix, ncomp, angle_list,
                              int(round(fwhm)), pa_threshold, ann_center)
                   for k in range(n)]
        klip = [list(v) for v in zip(*patches)]
        resicube = torch.zeros_like(cube)
        resicube[:, band_t[0], band_t[1]] = torch.stack(klip[3])
    elif model == "LOCI":
        resicube, ind_ref_list, coef_list = LOCI_FM(
            cube, psf, ann_center, angle_list, int(round(fwhm)), fwhm,
            tolerance, delta_rot, pa_threshold)
    else:
        raise ValueError("model should be KLIP or LOCI")
    mcube = cube_derotate(resicube, angle_list, imlib=imlib,
                          interpolation=interpolation)

    indicesy, indicesx = get_annulus_segments((y, x), ann_center, 1, 1)[0]
    var_f = _var_esti(mcube, angle_list, var, crop, ann_center)
    form = _pixels_fm_batched if _fmmf_batched_enabled(cube.device) \
        else _pixels_fm_serial
    prob_esti, flux_esti = form(
        cube, angle_list, psf, fwhm, model, var, ncomp, pa_threshold, crop,
        imlib, interpolation, mcube, indicesy, indicesx, var_f, band, klip,
        ind_ref_list, coef_list)
    if verbose:
        print(f"Radial distance {ann_center} done!")
    return prob_esti, flux_esti, ann_center


def _unit_models(shape, psf, angle_list, ys, xs, band, imlib, device, dtype):
    """The annulus columns ``band`` of the unit-flux companions at pixels
    (ys, xs) in every frame, as ``fm.cube_inject_companions`` injects them
    into an empty cube (flevel 1, one branch at the pixel's radius and
    angle): (P, n, len(band)) on ``device``. One batched sub-pixel shift
    of the stamp for all (pixel, frame) pairs, then one indexed add of the
    stamps, clipped at the frame edge, into the annulus columns."""
    ny, nx = shape
    n = len(angle_list)
    ceny, cenx = frame_center(shape)
    ys = np.asarray(ys, float)
    xs = np.asarray(xs, float)
    rad = np.sqrt((ys - ceny) ** 2 + (xs - cenx) ** 2)
    if np.any(rad >= nx / 2):
        raise ValueError("rad_dists last location is at the border (or "
                         "outside) of the field")
    ang = np.deg2rad(np.degrees(np.arctan2(ys - ceny, xs - cenx)))[:, None]
    a = np.deg2rad(np.asarray(angle_list, float))[None, :]
    shift_y = rad[:, None] * np.sin(ang - a)
    shift_x = rad[:, None] * np.cos(ang - a)
    int_y, int_x = shift_y.astype(int), shift_x.astype(int)
    dsy = (shift_y - int_y).reshape(-1)
    dsx = (shift_x - int_x).reshape(-1)
    P = len(ys)
    stamp = torch.as_tensor(psf, dtype=dtype, device=device)
    if imlib == "vip-fft":
        stamps = fourier_shift_batch(stamp.expand(P * n, *stamp.shape), dsy,
                                     dsx, 1)
    elif imlib == "ndimage-fourier":
        stamps = cyclic_fourier_shift(stamp, dsy, dsx)
    else:
        # cube_inject_companions' shift imlib for 'opencv' and 'skimage'
        # (vip_tpu fakecomp.py:112-121): every stamp in one cube_shift
        from ..preproc.recentering import cube_shift

        imlib_sh = "opencv" if imlib == "opencv" else "ndimage-interp"
        stamps = cube_shift(stamp.expand(P * n, *stamp.shape), dsy, dsx,
                            imlib=imlib_sh, border_mode="constant")
    sty, stx = _stamp_origin(ny, nx, psf.shape[-1])
    col_map = torch.full((ny * nx,), -1, dtype=torch.long, device=device)
    flat = torch.as_tensor(band[0] * nx + band[1], device=device)
    col_map[flat] = torch.arange(flat.shape[0], device=device)
    models = torch.zeros((P * n, flat.shape[0]), dtype=dtype, device=device)
    y0 = torch.as_tensor((sty + int_y).reshape(-1), device=device)
    x0 = torch.as_tensor((stx + int_x).reshape(-1), device=device)
    minus_one = torch.full((P * n,), -1.0, dtype=dtype, device=device)
    _place(models, col_map, stamps, y0, x0, minus_one, ny, nx)
    return models.reshape(P, n, -1)


def _klip_models(j, models, idx, refs_mean_sub, evecs, KL_basis, evals,
                 sci_mean_sub):
    """The forward models of frame ``j`` under its KLIP basis, Pueyo's
    (2016) first-order perturbation of the KL modes (vip_tpu
    fmmf.py:526), for a batch of unit-companion models (P, n, band): the
    model minus its over-subtraction and self-subtraction, (P, band).

    With C = Vᵀ (models_msub refsᵀ) V, W[k, i] = √e_i / (e_k - e_i)
    (C[k, i] + C[i, k]) off the diagonal and W[k, k] = -C[k, k] / √e_k,
    the perturbation of the basis is diag(1/√e) (W KL + Vᵀ models_msub)."""
    models_ref = models[:, idx, :]
    models_msub = torch.nan_to_num(
        models_ref - torch.nanmean(models_ref, dim=2, keepdim=True))
    model_sci = models[:, j, :]
    model_sci_msub = torch.nan_to_num(
        model_sci - torch.nanmean(model_sci, dim=1, keepdim=True))
    mb = KL_basis.shape[0]
    V = evecs[:, :mb]
    C = V.T @ (models_msub @ refs_mean_sub.T) @ V
    sqrt_e = torch.sqrt(evals[:mb])
    de = evals[:mb, None] - evals[None, :mb]
    tiny = 1e-300 if de.dtype == torch.float64 else 1e-30
    de = torch.where(de == 0, tiny, de)
    W = (sqrt_e[None, None, :] / de[None]) * (C + C.transpose(1, 2))
    dg = torch.arange(mb, device=W.device)
    W[:, dg, dg] = -C[:, dg, dg] / sqrt_e[None, :]
    delta_KL = (W @ KL_basis + V.T @ models_msub) / sqrt_e[None, :, None]
    oversub = (model_sci_msub @ KL_basis.T) @ KL_basis
    selfsub = ((delta_KL @ sci_mean_sub)[:, None, :] @ KL_basis)[:, 0] \
        + ((KL_basis @ sci_mean_sub)[None, None, :] @ delta_KL)[:, 0]
    return model_sci - oversub - selfsub


def _crop_windows(x, indicesy, indicesx, fwhm, crop):
    """Flat offsets of the S x S windows the serial form crops (vip_tpu
    fmmf.py:358-386): of each model frame, the centre of its (2 fwhm + 1)
    crop around the pixel (``cube_crop_frames``, then ``frame_crop``), and
    of the residual frames the ``frame_crop`` at the pixel, both with the
    parity size bumps of ``var.shapes.get_square``. (P, S²) each."""
    def adjust(n_init, size):
        return size + 1 if (n_init % 2 == 0) != (size % 2 == 0) else size

    cw1 = adjust(x, int(2 * round(fwhm) + 1))
    wing1 = (cw1 - 1) / 2
    if cw1 == crop:
        i0, S = 0, cw1
    else:
        S = adjust(cw1, crop)
        i0 = int(int(cw1 / 2) - (S - 1) / 2)
    if adjust(x, crop) != S:
        raise ValueError(f"fmmf: crop {crop} takes {adjust(x, crop)} px on "
                         f"the frames but {S} on the models")
    wingm = (S - 1) / 2
    sy = np.array([int(py - wing1) + i0 for py in indicesy])
    sx = np.array([int(px - wing1) + i0 for px in indicesx])
    my0 = np.array([int(py - wingm) for py in indicesy])
    mx0 = np.array([int(px - wingm) for px in indicesx])
    if min(sy.min(), sx.min(), my0.min(), mx0.min()) < 0 or \
            max(sy.max(), sx.max(), my0.max(), mx0.max()) + S > x:
        raise ValueError("fmmf: a crop window leaves the frame")
    q = np.arange(S)
    offs = (q[:, None] * x + q[None, :]).reshape(-1)
    return ((sy * x + sx)[:, None] + offs[None, :],
            (my0 * x + mx0)[:, None] + offs[None, :], S)


def _library_indices(angle_list, pa_threshold, n):
    if pa_threshold != 0:
        return [_find_indices_adi(angle_list, j, pa_threshold,
                                  truncate=False) for j in range(n)]
    return [np.arange(n) for _ in range(n)]


def _pixels_fm_batched(cube, angle_list, psf, fwhm, model, var, ncomp,
                       pa_threshold, crop, imlib, interpolation, mcube,
                       indicesy, indicesx, var_f, band, klip, ind_ref_list,
                       coef_list):
    """The per-pixel matched filter of :func:`_snr_contrast_esti`, batched
    (vip_tpu fmmf.py:249): the P unit models in one batch, the KLIP
    perturbation frame by frame over all pixels (the LOCI residuals as one
    contraction a frame), then the n x P model frames derotated in chunks
    of pixels and the crop windows gathered from them. Returns (prob_esti,
    flux_esti) of the P pixels."""
    n, y, x = cube.shape
    dev, dt = cube.device, cube.dtype
    P = len(indicesy)
    models = _unit_models((y, x), psf, angle_list, indicesy, indicesx, band,
                          imlib, dev, dt)
    if model == "LOCI":
        # the residuals of all frames first: the mean of each pixel's
        # model cube couples the frames
        res = torch.stack([
            models[:, j] - torch.einsum(
                "k,pkb->pb", as_tensor(coef_list[j], dev, dt),
                models[:, torch.as_tensor(ind_ref_list[j], device=dev)])
            for j in range(n)])                             # (n, P, band)
        sub = res.sum((0, 2)) / (n * y * x)                 # (P,)
        sub = sub[None, :].expand(n, P)
    else:
        evals, evecs, KL_basis, _, refs, sci = klip
        idx = _library_indices(angle_list, pa_threshold, n)
        res = torch.stack([
            _klip_models(j, models, torch.as_tensor(idx[j], device=dev),
                         refs[j], evecs[j], KL_basis[j], evals[j], sci[j])
            for j in range(n)])
        res = res - res.mean(2, keepdim=True)
        sub = torch.zeros((n, P), dtype=dt, device=dev)

    win, mwin, S = _crop_windows(x, indicesy, indicesx, fwhm, crop)
    win = torch.as_tensor(win, device=dev)
    mwin = torch.as_tensor(mwin, device=dev)
    mc_all = mcube.reshape(n, y * x)[:, mwin]               # (n, P, S²)
    svar = var_f[None, :].expand(P, n) if var_f.ndim == 1 else var_f
    bflat = torch.as_tensor(band[0] * x + band[1], device=dev)

    num = torch.empty((P, n), dtype=dt, device=dev)
    den = torch.empty_like(num)
    step = int(max(1, _FRAMES_BUDGET // (n * y * x * cube.element_size())))
    for lo in range(0, P, step):
        pc = slice(lo, min(P, lo + step))
        m = pc.stop - pc.start
        frames = torch.zeros((n, m, y * x), dtype=dt, device=dev)
        frames[:, :, bflat] = res[:, pc]
        frames -= sub[:, pc, None]
        rot = cube_derotate(frames.reshape(n * m, y, x),
                            np.repeat(angle_list, m), imlib=imlib,
                            interpolation=interpolation)
        rt = rot.reshape(n, m, y * x).gather(
            2, win[pc][None].expand(n, m, S * S))
        num[pc] = torch.einsum("npc,npc->pn", mc_all[:, pc], rt) / svar[pc]
        den[pc] = torch.einsum("npc,npc->pn", rt, rt) / svar[pc]
    return num.sum(1) / den.sum(1), num.sum(1) / torch.sqrt(den.sum(1))


def _pixels_fm_serial(cube, angle_list, psf, fwhm, model, var, ncomp,
                      pa_threshold, crop, imlib, interpolation, mcube,
                      indicesy, indicesx, var_f, band, klip, ind_ref_list,
                      coef_list):
    """The per-pixel matched filter of :func:`_snr_contrast_esti`, pixel by
    pixel (vip_tpu fmmf.py:158): each pixel's unit model, its n forward
    models (``_perturb`` frame by frame, or the LOCI residuals), one
    derotation of its n frames, the crops and the sums. Returns
    (prob_esti, flux_esti) of the P pixels."""
    n, y, x = cube.shape
    dev, dt = cube.device, cube.dtype
    P = len(indicesy)
    bt = tuple(torch.as_tensor(i, device=dev) for i in band)
    prob_esti = torch.zeros(P, dtype=dt, device=dev)
    flux_esti = torch.zeros(P, dtype=dt, device=dev)
    for i in range(P):
        px, py = indicesx[i], indicesy[i]
        values = _unit_models((y, x), psf, angle_list, [py], [px], band,
                              imlib, dev, dt)[0]            # (n, band)
        frames = torch.zeros_like(cube)
        if model == "KLIP":
            evals, evecs, KL_basis, _, refs, sci = klip
            for b in range(n):
                fm = _perturb(b, values, ncomp, evals, evecs, KL_basis, sci,
                              refs, angle_list, fwhm, pa_threshold,
                              ann_center=None)
                frames[b, bt[0], bt[1]] = fm - fm.mean()
        else:
            for e in range(n):
                recon = as_tensor(coef_list[e], dev, dt) \
                    @ values[torch.as_tensor(ind_ref_list[e], device=dev)]
                frames[e, bt[0], bt[1]] = values[e] - recon
            frames = frames - frames.mean()
        der = cube_derotate(frames, angle_list, imlib=imlib,
                            interpolation=interpolation)
        psfm = cube_crop_frames(der, int(2 * round(fwhm) + 1), xy=(px, py),
                                verbose=False)
        if psfm.shape[1] != crop:
            c = int(psfm.shape[-1] / 2)
            psfm = cube_crop_frames(psfm, crop, xy=(c, c), verbose=False)
        mc = cube_crop_frames(mcube, crop, xy=(px, py), verbose=False)
        svar = var_f if var_f.ndim == 1 else var_f[i]
        num = (mc * psfm).sum((1, 2)) / svar
        den = (psfm * psfm).sum((1, 2)) / svar
        flux_esti[i] = num.sum() / torch.sqrt(den.sum())
        prob_esti[i] = num.sum() / den.sum()
    return prob_esti, flux_esti


def _var_esti(mcube, angle_list, var, crop, ann_center):
    """Noise variance of the derotated residuals (vip_tpu fmmf.py:465):
    'FR' one a frame over the annulus of width ``crop``; 'FM' one a pixel
    of the annulus and frame, without the disk of radius 3 around the
    pixel; 'TE' one a pixel and frame over the crop box at the pixel's
    position in the other frames of the re-rotated cube. A tensor on the
    cube's device, (n,) or (P, n)."""
    mcube = as_tensor(mcube)
    n, y, x = mcube.shape
    dev, dt = mcube.device, mcube.dtype
    if var in ("FR", VarEstim.FR):
        yy, xx = get_annulus_segments((y, x), ann_center - int(crop / 2),
                                      crop, 1)[0]
        return mcube[:, torch.as_tensor(yy, device=dev),
                     torch.as_tensor(xx, device=dev)].var(1, correction=0)
    if var in ("FM", VarEstim.FM):
        py, px = get_annulus_segments((y, x), ann_center, 1, 1)[0]
        yy, xx = get_annulus_segments((y, x), ann_center - int(crop / 2),
                                      crop, 1)[0]
        keep = torch.as_tensor(
            (yy[None] - py[:, None]) ** 2 + (xx[None] - px[:, None]) ** 2
            >= 3 ** 2, device=dev).to(dt)                   # (P, m)
        vals = mcube[:, torch.as_tensor(yy, device=dev),
                     torch.as_tensor(xx, device=dev)]       # (n, m)
        count = keep.sum(1, keepdim=True)
        mean = keep @ vals.T / count                         # (P, n)
        dev2 = (vals[None] - mean[:, :, None]) ** 2          # (P, n, m)
        return (dev2 * keep[:, None, :]).sum(2) / count
    if var in ("TE", VarEstim.TE):
        py, px = get_annulus_segments((y, x), ann_center, 1, 1)[0]
        derot = _host(cube_derotate(mcube, -np.asarray(angle_list)))
        var_f = np.zeros((len(py), n))
        h = int(crop / 2)
        for a in range(len(py)):
            radist = np.sqrt((px[a] - int(x / 2)) ** 2
                             + (py[a] - int(y / 2)) ** 2)
            ang_s = np.arccos((px[a] - int(x / 2)) / radist) / np.pi * 180
            if py[a] - int(y / 2) < 0:
                ang_s = 360 - ang_s
            for b in range(n):
                t = (ang_s - angle_list[b]) / 360 * 2 * np.pi
                sy = int(y / 2 + np.sin(t) * radist)
                sx = int(x / 2 + np.cos(t) * radist)
                others = np.ones(n, dtype=bool)
                others[b] = False
                var_f[a, b] = np.var(derot[others, sy - h:sy + h + 1,
                                           sx - h:sx + h + 1])
        return torch.as_tensor(var_f, dtype=dt, device=dev)
    raise ValueError("var estimation method not recognized")


def _perturb(frame, model_matrix, numbasis, evals_matrix, evecs_matrix,
             KL_basis_matrix, sci_mean_sub_matrix, refs_mean_sub_matrix,
             angle_list, fwhm, pa_threshold, ann_center):
    """Forward model of frame ``frame`` under its KLIP basis, for the unit
    model ``model_matrix`` (n, band) of one pixel (vip_tpu fmmf.py:526):
    the model minus its over- and self-subtraction. A (band,) tensor."""
    model_matrix = as_tensor(model_matrix)
    dev = model_matrix.device
    n = model_matrix.shape[0]
    idx = _find_indices_adi(angle_list, frame, pa_threshold,
                            truncate=False) if pa_threshold != 0 \
        else np.arange(n)
    return _klip_models(frame, model_matrix[None],
                        torch.as_tensor(idx, device=dev),
                        refs_mean_sub_matrix[frame], evecs_matrix[frame],
                        KL_basis_matrix[frame], evals_matrix[frame],
                        sci_mean_sub_matrix[frame])[0]


def KLIP_patch(frame, matrix, numbasis, angle_list, fwhm, pa_threshold,
               ann_center, nframes=None):
    """KLIP of one frame of an annulus (vip_tpu fmmf.py:584): its reference
    library (the frames past the PA threshold; at most 200, the closest in
    angle, beyond 20 FWHM), the library's top eigenvectors of the
    covariance and the KL basis. Returns (evals, evecs, KL_basis,
    residual, refs_mean_sub, sci_mean_sub), tensors on the matrix's
    device."""
    matrix = as_tensor(matrix)
    dev = matrix.device
    max_frames_lib = 200
    if pa_threshold != 0:
        if ann_center > fwhm * 20:
            indices_left = _find_indices_adi(angle_list, frame, pa_threshold,
                                             truncate=True,
                                             max_frames=max_frames_lib)
        else:
            indices_left = _find_indices_adi(angle_list, frame, pa_threshold,
                                             truncate=False, nframes=nframes)
        if len(indices_left) == 0:
            raise ValueError("No frame index left matching pa threshold. "
                             "Reduce delta_rot.")
        refs = matrix[torch.as_tensor(indices_left, device=dev)]
    else:
        refs = matrix

    sci = matrix[frame]
    sci_mean_sub = sci - torch.nanmean(sci)
    refs_mean_sub = refs - torch.nanmean(refs, dim=1, keepdim=True)
    # numpy's cov of the rows (their means removed once more) times N - 1
    N = sci.shape[0]
    centred = refs_mean_sub - refs_mean_sub.mean(1, keepdim=True)
    covar = (centred @ centred.T) * (1.0 / (N - 1)) * (N - 1)

    tot_basis = covar.shape[0]
    max_basis = int(np.max(np.clip(np.asarray(numbasis) - 1, 0,
                                   tot_basis - 1))) + 1
    evals, evecs = torch.linalg.eigh(covar)
    evals = evals[tot_basis - max_basis:].flip(0)
    evecs = evecs[:, tot_basis - max_basis:].flip(1)
    KL_basis = ((refs_mean_sub.T @ evecs)
                * (1.0 / torch.sqrt(evals))[None, :]).T
    residual = sci_mean_sub - (sci_mean_sub @ KL_basis.T) @ KL_basis
    return evals, evecs, KL_basis, residual, refs_mean_sub, sci_mean_sub


def LOCI_FM(cube, psf, ann_center, angle_list, asize, fwhm, Tol, delta_rot,
            pa_threshold):
    """LOCI residuals of the three annuli around ``ann_center`` and the
    middle one's reference indices and coefficients, which the forward
    models reuse (vip_tpu fmmf.py:635). Returns (residual cube tensor,
    ind_ref_list, coef_list)."""
    cube = as_tensor(cube)
    dev = cube.device
    cube_res = torch.zeros_like(cube)
    radius_int = max(ann_center - int(1.5 * asize), 1)
    ind_ref_list = coef_list = None
    for ann in range(3):
        inner_radius_ann = radius_int + ann * asize
        (yy, xx), = get_annulus_segments(tuple(cube.shape[1:]),
                                         inner_radius=inner_radius_ann,
                                         width=asize, nsegm=1)
        (yo, xo), = get_annulus_segments(tuple(cube.shape[1:]),
                                         inner_radius=inner_radius_ann,
                                         width=asize, nsegm=1,
                                         optim_scale_fact=2)
        ayxyx = [inner_radius_ann, pa_threshold, yy, xx, yo, xo]
        matrix_res, ind_ref, coef, yy, xx = _leastsq_patch_fm(
            ayxyx, angle_list, fwhm, cube, 100, Tol, psf=psf)
        if ann == 1:
            ind_ref_list, coef_list = ind_ref, coef
        cube_res[:, torch.as_tensor(yy, device=dev),
                 torch.as_tensor(xx, device=dev)] = matrix_res
    return cube_res, ind_ref_list, coef_list


def _lstsq_rcond(A, b, rcond):
    """numpy's ``lstsq(A, b, rcond)``: the minimum-norm least-squares
    solution with singular values at or below rcond times the largest
    dropped."""
    U, s, Vh = svd(A)
    keep = s > rcond * s[0]
    inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return Vh.T @ (inv * (U.T @ b))


def _leastsq_patch_fm(ayxyx, angle_list, fwhm, cube, dist_threshold, tol,
                      psf=None):
    """LOCI coefficients of each frame of one annulus over its optimization
    zone, and the frame's residual (vip_tpu fmmf.py:666). Returns
    (residuals tensor (n, npix), ind_ref_list, coef_list, yy, xx)."""
    ann_center, pa_threshold, yy, xx, yy_opti, xx_opti = ayxyx
    cube = as_tensor(cube)
    dev = cube.device
    values = cube[:, torch.as_tensor(yy, device=dev),
                  torch.as_tensor(xx, device=dev)]
    values_opt = cube[:, torch.as_tensor(yy_opti, device=dev),
                      torch.as_tensor(xx_opti, device=dev)]
    matrix_res = torch.zeros_like(values)
    ind_ref_list, coef_list = [], []
    for i in range(cube.shape[0]):
        ind_fr_i = _find_indices_adi(angle_list, i, pa_threshold,
                                     truncate=False)
        if len(ind_fr_i) == 0:
            raise RuntimeError("No frames left in the reference set. Try "
                               "increasing `dist_threshold` or decreasing "
                               "`delta_rot`.")
        ind_t = torch.as_tensor(ind_fr_i, device=dev)
        coef = _lstsq_rcond(values_opt[ind_t].T, values_opt[i], tol)
        ind_ref_list.append(ind_fr_i)
        coef_list.append(coef)
        matrix_res[i] = values[i] - coef @ values[ind_t]
    return matrix_res, ind_ref_list, coef_list, yy, xx

"""ANDROMEDA: maximum-likelihood detection of companions in ADI sequences
([CAN15], [MUG09]; port of ``vip_tpu.invprob.andromeda``).

The host keeps the control flow of vip_tpu (annuli limits, frame pairing,
the SNR normalization's ladder); the data stay on the cube's device: the
centring shift and the Hann high-pass filter of the cube are one batched
FFT each, the optimized differences of an annulus' frame pairs are
reductions over the pairs (the L1 fits of every pair at once, through
``utils_andro.fitaffine``), and the matched filter of ``andromeda_core``
is batched gathers over (pixel, pair): each pixel's S x S window of both
frames of every pair, with its pattern from the sub-pixel PSF bank, and
the cross term of the two patterns where their windows overlap. The
pixels go in chunks whose gathers stay under the 8 GiB working set of
``preproc.derotation._auto_chunk``; nothing loops over pixels on the
host. The pixel geometry (the rotated positions, their floors and
sub-pixel steps) is float64 whatever the data's dtype.
"""

from dataclasses import dataclass
from enum import Enum
from typing import List, Union

import numpy as np
import torch

from ..config.device import as_tensor
from ..config.paramenum import ALGO_KEY, OptMethod
from ..config.utils_param import separate_kwargs_dict
from ..fm.fakecomp import _host
from ..var.coords import dist_matrix
from ..var.filters import cube_filter_highpass, frame_filter_highpass
from .utils_andro import (_median, calc_psf_shift_subpix, fitaffine,
                          idl_where, subpixel_shift)

__all__ = ["andromeda", "ANDROMEDA_Params"]

#: Working set of one chunk of pixels of the matched filter (bytes): the
#: budget of ``preproc.derotation._auto_chunk``
_WORKING_SET = 8 << 30


@dataclass
class ANDROMEDA_Params:
    """Parameters of :func:`andromeda` (vip_tpu andromeda.py:31)."""

    cube: np.ndarray = None
    oversampling_fact: float = None
    angle_list: np.ndarray = None
    psf: np.ndarray = None
    filtering_fraction: float = 0.25
    min_sep: float = 0.5
    annuli_width: float = 1.0
    roa: float = 2
    opt_method: Enum = OptMethod.LSQ
    nsmooth_snr: int = 18
    iwa: float = None
    owa: float = None
    precision: int = 50
    fast: Union[float, bool] = False
    homogeneous_variance: bool = True
    ditimg: float = 1.0
    ditpsf: float = None
    tnd: float = 1.0
    total: bool = False
    multiply_gamma: bool = True
    nproc: int = 1
    verbose: bool = False


def _centre(frames):
    """Shift frames to LibAndromeda's centre at npix/2 + 0.5: by half a
    pixel up and right and dropping the first row and column for odd
    frames, down and left for even ones (vip_tpu andromeda.py:88-97)."""
    if frames.shape[-1] % 2 == 1:
        return subpixel_shift(frames, 0.5, 0.5)[..., 1:, 1:]
    return subpixel_shift(frames, -0.5, -0.5)


def andromeda(*all_args: List, **all_kwargs: dict):
    """Run ANDROMEDA on an ADI cube (vip_tpu andromeda.py:60). The cube
    runs on its own device (numpy input on the default device). Returns
    (contrast, snr, snr_norm, stdcontrast, stdcontrast_norm, likelihood)
    as tensors on that device, and ext_radius."""
    class_params, other_options = separate_kwargs_dict(
        initial_kwargs=all_kwargs, parent_class=ANDROMEDA_Params)
    algo_params = other_options.pop(ALGO_KEY, None)
    if algo_params is None:
        algo_params = ANDROMEDA_Params(*all_args, **class_params)
    p = algo_params

    def info(msg, *fmt):
        if p.verbose:
            print(msg.format(*fmt))

    # the parallactic angles in IDL's convention
    angle_list = -_host(p.angle_list)
    cube = as_tensor(p.cube)
    psf = as_tensor(p.psf, cube.device, cube.dtype)
    andro_cube = _centre(cube)
    psf = _centre(psf)

    if p.filtering_fraction > 1 or p.filtering_fraction < 0:
        raise ValueError("``filtering_fraction`` must be between 0 and 1")

    frames, npix, _ = andro_cube.shape
    npixpsf = psf.shape[0]

    if p.opt_method != "no" and p.opt_method != OptMethod.NO:
        if p.roa < 1:
            raise ValueError("The optimization to subtraction area ``roa`` "
                             "must be >= 1")
    else:
        p.roa = 1

    iwa, owa = p.iwa, p.owa
    if iwa is None:
        for test_iwa in [0.5, 4, 0.25]:
            test_ang = 2 * np.arcsin(p.min_sep / (2 * test_iwa)) * 180 / np.pi
            test_id, _, _ = create_indices(angle_list, angmin=test_ang)
            if test_id is not None:
                break
        iwa = test_iwa
        info("iwa automatically set to {}*lambda/D", iwa)
    if owa is None:
        owa = (npix / 2 - npixpsf / 2) / (2 * p.oversampling_fact)
        info("owa automatically set to {} (based on frame size)", owa)
    else:
        owa -= (npixpsf / 2) / (2 * p.oversampling_fact)
    if owa <= iwa - p.annuli_width:
        raise ValueError("You must increase `owa` or decrease `iwa`")

    fast = p.fast
    dmean = None
    if fast is False:
        pass
    elif fast is True:
        fast = 20
        if owa > fast:
            dmean = fast
        else:
            fast = 0
        if iwa > fast:
            dmean = owa
    else:
        if owa > fast:
            dmean = fast
        else:
            fast = 0
    if fast:
        info("annuli_width is set to {} from {} lambda/D",
             4 * p.annuli_width, dmean)

    ditpsf = p.ditpsf if p.ditpsf is not None else p.ditimg

    if p.nsmooth_snr != 0 and p.nsmooth_snr < 2:
        raise ValueError("`nsmooth_snr` must be >= 2")

    # the PSF normalized, both high-pass filtered, the sub-pixel PSF bank
    psf_scale_factor = float(psf.sum() if p.total else psf.max())
    psf = psf / psf_scale_factor
    if p.filtering_fraction != 1:
        psf = frame_filter_highpass(psf, "hann",
                                    hann_cutoff=p.filtering_fraction)
    psf_cube = calc_psf_shift_subpix(psf, precision=p.precision)
    if p.filtering_fraction != 1:
        andro_cube = cube_filter_highpass(andro_cube, mode="hann",
                                          hann_cutoff=p.filtering_fraction)
        info("Pre-processing filtering of the images and the PSF: done! "
             "F={}", p.filtering_fraction)

    # annuli limits (vip_tpu andromeda.py:176-201)
    dmin, dmax = iwa, owa
    if fast:
        first_distarray = dmin + np.arange(
            int(np.round(np.abs(dmean - dmin - 1)) / p.annuli_width + 1),
            dtype=float) * p.annuli_width
        second_distarray = dmean + dmin - 1 + np.arange(
            int(np.round(dmax - dmean) / (4 * p.annuli_width) + 1),
            dtype=float) * 4 * p.annuli_width
        distarray_lambdaonD = np.hstack([first_distarray, second_distarray])
        if iwa > fast:
            distarray_lambdaonD = first_distarray
        if distarray_lambdaonD[-1] > dmax:
            distarray_lambdaonD[-1] = dmax
        annuli_limits = p.oversampling_fact * 2 * distarray_lambdaonD
    else:
        distarray_lambdaonD = dmin + np.arange(
            int(np.round(dmax - dmin) / p.annuli_width + 1),
            dtype=float) * p.annuli_width
        distarray_lambdaonD[-1] = dmax
        annuli_limits = np.floor(
            p.oversampling_fact * 2 * distarray_lambdaonD).astype(int)

    while dmax * (2 * p.oversampling_fact) < annuli_limits[-1]:
        annuli_limits = annuli_limits[:-1]
    annuli_number = len(annuli_limits) - 1
    info("Using these user parameters, {} annuli will be processed, from a "
         "separation of {} to {} pixels.", annuli_number, annuli_limits[0],
         annuli_limits[-1])

    maps = torch.zeros((4, npix, npix), dtype=cube.dtype, device=cube.device)
    for i in range(annuli_number)[::-1]:
        res = _process_annulus(
            i, annuli_limits, p.roa, p.min_sep, p.oversampling_fact,
            angle_list, p.opt_method, p.multiply_gamma, psf_cube,
            p.homogeneous_variance, andro_cube, verbose=p.verbose)
        if res is not None:
            maps += torch.stack(res)
    flux, snr, likelihood, stdflux = maps

    flux_factor = 1 / psf_scale_factor * p.tnd * (ditpsf / p.ditimg)
    if p.nsmooth_snr != 0:
        info("Normalizing SNR...")
        snr_norm, snr_std = normalize_snr(snr, nsmooth_snr=p.nsmooth_snr,
                                          fast=fast)
        stdflux_norm = torch.where(snr_std != 0, stdflux * snr_std, 0.0)
        ext_radius = annuli_limits[annuli_number - 1] / (
            2 * p.oversampling_fact)
        return (flux * flux_factor, snr, snr_norm, stdflux * flux_factor,
                stdflux_norm * flux_factor, likelihood, ext_radius)
    ext_radius = np.floor(annuli_limits[annuli_number]) / (
        2 * p.oversampling_fact)
    return (flux * flux_factor, snr, snr, stdflux * flux_factor,
            stdflux * flux_factor, likelihood, ext_radius)


def _process_annulus(i, annuli_limits, roa, min_sep, oversampling_fact,
                     angle_list, opt_method, multiply_gamma, psf_cube,
                     homogeneous_variance, cube, verbose=False):
    """Pair the frames, form the optimized differences and run the matched
    filter on annulus ``i`` (vip_tpu andromeda.py:244). None when no pair
    is far enough apart."""
    rhomin = annuli_limits[i]
    rhomax = annuli_limits[i + 1]
    rhomax_opt = np.sqrt(roa * rhomax ** 2 - (roa - 1) * rhomin ** 2)

    min_sep_pix = min_sep * oversampling_fact * 2
    angmin = 2 * np.arcsin(min_sep_pix / (2 * rhomin)) * 180 / np.pi
    index_neg, index_pos, _ = create_indices(angle_list, angmin,
                                             verbose=verbose)
    if index_neg is None:
        if verbose:
            print("  Warning: No couples found for this distance. "
                  "Skipping annulus...")
        return None

    dev = cube.device
    cube_diff, gamma, gamma_prime = diff_images(
        cube_pos=cube[torch.as_tensor(index_pos, device=dev)],
        cube_neg=cube[torch.as_tensor(index_neg, device=dev)],
        rint=rhomin, rext=rhomax_opt, opt_method=opt_method, verbose=verbose)
    if not multiply_gamma:
        gamma = torch.ones_like(gamma)
    return andromeda_core(diffcube=cube_diff, index_neg=index_neg,
                          index_pos=index_pos, angle_list=angle_list,
                          psf_cube=psf_cube,
                          homogeneous_variance=homogeneous_variance,
                          rhomin=rhomin, rhomax=rhomax, gamma=gamma,
                          verbose=verbose)


def _pair_geometry(jj, ii, parang, npix, S, precision, device):
    """Float64 geometry of the matched filter for pixels (jj, ii) and the
    (2, K) pair angles (radians; row 0 the negative frames): the flat
    offset of each S x S window in the S-padded frames and the bank index
    of each pattern, both (P, 2, K), and the row and column offsets of the
    negative window from the positive one, (P, K) each (vip_tpu
    andromeda.py:284-330)."""
    half = npix // 2
    jj = torch.as_tensor(jj, dtype=torch.float64, device=device)
    ii = torch.as_tensor(ii, dtype=torch.float64, device=device)
    parang = torch.as_tensor(parang, dtype=torch.float64, device=device)
    x0 = (ii - (npix / 2 - 0.5))[:, None, None]
    y0 = (jj - (npix / 2 - 0.5))[:, None, None]
    cosp, sinp = torch.cos(parang)[None], torch.sin(parang)[None]
    decalx = x0 * cosp - y0 * sinp
    decaly = y0 * cosp + x0 * sinp
    fx, fy = torch.floor(decalx), torch.floor(decaly)
    # the fraction rounds (half away from zero) to a step of 0 or 1, times
    # the precision, as vip_tpu's engine does
    subp_x = (torch.trunc(decalx - fx + 0.5) * precision).long()
    subp_y = (torch.trunc(decaly - fy + 0.5) * precision).long()
    lef = half + fx.long() - S // 2
    bot = half + fy.long() - S // 2
    side = npix + 2 * S
    # window corners in the padded frame, clamped as a dynamic slice is
    row0 = (bot + S).clamp(0, side - S)
    col0 = (lef + S).clamp(0, side - S)
    return (row0 * side + col0, subp_y * (precision + 1) + subp_x,
            bot[:, 0] - bot[:, 1], lef[:, 0] - lef[:, 1])


def _matched_filter(wd_flat, w_flat, psf_flat, corner, bank, dy, dx, gamma,
                    S, side):
    """Numerator and denominator of the ML flux of a chunk of pixels,
    summed over the K pairs: windows gathered at ``corner`` (P, 2, K) from
    the padded weighted differences ``wd_flat`` (K, side²) and weights
    ``w_flat`` (side²), patterns from ``psf_flat`` at ``bank`` (P, 2, K),
    and the cross term of the negative pattern shifted by (dy, dx) into
    the positive window."""
    dev = wd_flat.device
    q = torch.arange(S, device=dev)
    offs = (q[:, None] * side + q[None, :]).reshape(-1)          # (S²,)
    idx = corner[..., None] + offs                                 # P,2,K,S²
    K = wd_flat.shape[0]
    k_ix = torch.arange(K, device=dev)[None, None, :, None]
    wd = wd_flat[k_ix, idx]
    w = w_flat[idx]
    pat = psf_flat[bank]                                           # P,2,K,S²
    g = gamma[None, :]
    num = (pat[:, 1] * wd[:, 1]).sum(-1) - g * (pat[:, 0] * wd[:, 0]).sum(-1)
    den = ((pat[:, 1] ** 2 * w[:, 1]).sum(-1)
           + g ** 2 * (pat[:, 0] ** 2 * w[:, 0]).sum(-1))
    # the negative pattern at (u - dy, v - dx) of the positive window,
    # zero outside its own S x S support or when the windows do not meet
    u = q[None, None, :] - dy[..., None]                           # P,K,S
    v = q[None, None, :] - dx[..., None]
    meet = ((dy.abs() < S) & (dx.abs() < S))[..., None, None]
    inside = ((u >= 0) & (u < S))[..., :, None] \
        & ((v >= 0) & (v < S))[..., None, :]
    src = (u.clamp(0, S - 1)[..., :, None] * S
           + v.clamp(0, S - 1)[..., None, :]).reshape(*u.shape[:2], -1)
    neg_in_pos = torch.where((inside & meet).reshape(src.shape),
                             pat[:, 0].gather(-1, src), 0.0)
    den = den - 2 * g * (pat[:, 1] * neg_in_pos * w[:, 1]).sum(-1)
    return num.sum(-1), den.sum(-1)


def andromeda_core(diffcube, index_neg, index_pos, angle_list, psf_cube,
                   rhomin, rhomax, gamma=None, homogeneous_variance=True,
                   verbose=False):
    """Flux, SNR, likelihood and flux-error maps of one annulus from its
    optimized pair differences (vip_tpu andromeda.py:369), on the
    differences' device. Returns four (npix, npix) tensors."""
    diffcube = as_tensor(diffcube)
    dev, dt = diffcube.device, diffcube.dtype
    psf_cube = as_tensor(psf_cube, dev, dt)
    npairs, npix, _ = diffcube.shape
    npixpsf = psf_cube.shape[2]
    precision = psf_cube.shape[0] - 1

    if npix % 2 == 1:
        raise ValueError("size of the cube is odd!")
    if npixpsf % 2 == 1:
        raise ValueError("PSF has odd pixel size!")

    if npairs == 1:
        variance_diff_2d = torch.ones((npix, npix), dtype=dt, device=dev)
    else:
        variance_diff_2d = (diffcube ** 2).sum(0) / npairs - (
            diffcube.sum(0) / npairs) ** 2
    if homogeneous_variance:
        varmean = variance_diff_2d.mean()
        weights_diff_2d = torch.full_like(variance_diff_2d, 1.0) / varmean
        if verbose:
            print(f"    ANDROMEDA_CORE: Variance is considered homogeneous, "
                  f"mean {float(varmean):.3f}")
    else:
        weights_diff_2d = (variance_diff_2d > 0).to(dt) / (
            variance_diff_2d + (variance_diff_2d == 0).to(dt))

    d = dist_matrix(npix)
    select_pixels = (d > rhomin) & (d < rhomax)
    rmax_i = int(np.ceil(rhomax))
    window = np.zeros_like(select_pixels)
    window[npix // 2 - rmax_i:npix // 2 + rmax_i,
           npix // 2 - rmax_i:npix // 2 + rmax_i] = True
    jj, ii = np.nonzero(select_pixels & window)
    zeros = torch.zeros((npix, npix), dtype=dt, device=dev)
    if len(jj) == 0:
        return zeros, zeros.clone(), zeros.clone(), zeros.clone()

    gamma = torch.ones(npairs, dtype=dt, device=dev) if gamma is None \
        else as_tensor(gamma, dev, dt)
    parang = np.array([angle_list[index_neg],
                       angle_list[index_pos]]) * np.pi / 180

    S = npixpsf
    side = npix + 2 * S
    wd_pad = torch.zeros((npairs, side, side), dtype=dt, device=dev)
    wd_pad[:, S:S + npix, S:S + npix] = diffcube * weights_diff_2d
    w_pad = torch.zeros((side, side), dtype=dt, device=dev)
    w_pad[S:S + npix, S:S + npix] = weights_diff_2d
    wd_flat = wd_pad.reshape(npairs, -1)
    w_flat = w_pad.reshape(-1)
    psf_flat = psf_cube.reshape(-1, S * S)

    # about ten (2, K, S²) tensors a pixel, their indices int64
    per_pixel = 10 * 2 * npairs * S * S * 8
    chunk = int(max(1, _WORKING_SET // per_pixel))
    nums, dens = [], []
    for lo in range(0, len(jj), chunk):
        corner, bank, dy, dx = _pair_geometry(
            jj[lo:lo + chunk], ii[lo:lo + chunk], parang, npix, S, precision,
            dev)
        num, den = _matched_filter(wd_flat, w_flat, psf_flat, corner, bank,
                                   dy, dx, gamma, S, side)
        nums.append(num)
        dens.append(den)
    pix = torch.as_tensor(jj * npix + ii, device=dev)
    numerator = zeros.clone().reshape(-1)
    denominator = torch.ones_like(numerator)
    numerator[pix] = torch.cat(nums)
    denominator[pix] = torch.cat(dens)
    numerator = numerator.reshape(npix, npix)
    denominator = denominator.reshape(npix, npix)

    flux = numerator / denominator
    snr = numerator / torch.sqrt(denominator)
    likelihood = 0.5 * snr ** 2
    stdflux = flux / (snr + (snr == 0).to(dt))
    return flux, snr, likelihood, stdflux


def create_indices(angle_list, angmin, verbose=True):
    """Pair each frame with the first frame at least ``angmin`` degrees
    further in angle, or else the last one that far back (vip_tpu
    andromeda.py:447). Host numpy; (None, None, []) when no pair
    exists."""
    angle_list = np.asarray(angle_list, dtype=float)
    if angle_list[-1] < angle_list[0]:
        angle_list = -angle_list

    good_angles = idl_where(angle_list - angle_list[0] >= angmin)
    if len(good_angles) == 0:
        if verbose:
            print("Impossible to find any couple of angles! Try to reduce "
                  "the IWA first, else you need to reduce the minimum "
                  "separation.")
        return None, None, []

    indices_neg = [0]
    indices_pos = [good_angles[0]]
    indices_not_used = []
    for i in range(1, len(angle_list)):
        good_angles = idl_where(angle_list - angle_list[i] >= angmin)
        if len(good_angles) > 0:
            indices_neg.append(i)
            indices_pos.append(good_angles[0])
        elif i not in indices_pos:
            good_angles_back = idl_where(angle_list[i] - angle_list
                                         >= angmin)
            if len(good_angles_back) > 0:
                indices_neg.append(i)
                indices_pos.append(good_angles_back[-1])
            else:
                indices_not_used.append(i)
    return np.array(indices_neg), np.array(indices_pos), indices_not_used


def diff_images(cube_pos, cube_neg, rint, rext, opt_method="lsq",
                variance_pos=None, variance_neg=None, verbose=False):
    """Optimized differences cube_pos - γ·cube_neg - γ' of two stacks of
    frames, γ (and γ') fitted over the annulus rint < r ≤ rext (vip_tpu
    andromeda.py:487): 'no' (γ = 1), 'total' (ratio of sums), 'lsq'
    (least squares), 'l1' (the robust affine fit of every pair at once).
    Returns (differences, gamma, gamma_prime) as tensors on the stacks'
    device."""
    cube_pos = as_tensor(cube_pos)
    cube_neg = as_tensor(cube_neg, cube_pos.device, cube_pos.dtype)
    nimg, npix, _ = cube_pos.shape
    gamma = torch.zeros(nimg, dtype=cube_pos.dtype, device=cube_pos.device)
    gamma_prime = torch.zeros_like(gamma)

    distarray = dist_matrix(npix)
    annulus = torch.as_tensor((distarray > rint) & (distarray <= rext),
                              device=cube_pos.device)
    if opt_method in ["no", 1, OptMethod.NO]:
        print("    DIFF_IMAGES: no optimisation is being performed. Note "
              "that keywords rint and rext will be ignored.")
        gamma += 1
    else:
        if verbose:
            print(f"  DIFF_IMAGES: optimization annulus limits: "
                  f"{rint:.1f} -> {rext:.1f}")
        ann_pos = cube_pos[:, annulus]
        ann_neg = cube_neg[:, annulus]
        if opt_method in ["total", 2, OptMethod.TOTAL]:
            gamma = ann_pos.sum(1) / ann_neg.sum(1)
        elif opt_method in ["lsq", 3, OptMethod.LSQ]:
            gamma = (ann_pos * ann_neg).sum(1) / (ann_neg ** 2).sum(1)
        elif opt_method in ["l1", 4, OptMethod.L1]:
            gamma, gamma_prime = fitaffine(y=ann_pos, x=ann_neg)
        else:
            raise ValueError(f"opt_method '{opt_method}' unknown")
    if verbose:
        print(f"    DIFF_IMAGES: median gamma={float(_median(gamma)):.3f}, "
              f"median gamma_prime={float(_median(gamma_prime)):.3f}")
    cube_diff = cube_pos - cube_neg * gamma[:, None, None] \
        - gamma_prime[:, None, None]
    return cube_diff, gamma, gamma_prime


def _ring_robust_std(values, radii, lo, hi):
    """Robust std of ``values`` over each ring lo[r] ≤ radius ≤ hi[r] (NaN
    for an empty ring), all rings in one masked sort."""
    member = (radii[None, :] >= lo[:, None]) & (radii[None, :] <= hi[:, None])
    count = member.sum(1)
    inf = torch.tensor(float("inf"), dtype=values.dtype, device=values.device)

    def ring_median(v):
        s = torch.sort(torch.where(member, v, inf), dim=1).values
        c = count.clamp(min=1)
        mid = (s.gather(1, ((c - 1) // 2)[:, None])
               + s.gather(1, (c // 2)[:, None]))[:, 0] / 2
        return torch.where(count > 0, mid, torch.nan)

    med = ring_median(values[None, :].expand(len(lo), -1))
    return ring_median((values[None, :] - med[:, None]).abs()) / 0.6745


def _paint(image, radii, lo, hi, values):
    """``image`` with each ring lo[r] ≤ radius ≤ hi[r] set to values[r] in
    turn, the later ring winning where rings overlap."""
    if len(lo) == 0:
        return image
    member = (radii[None, :] >= lo[:, None]) & (radii[None, :] <= hi[:, None])
    R = member.shape[0]
    last = R - 1 - member.flip(0).to(torch.uint8).argmax(0)
    painted = torch.where(member.any(0), values[last], image.reshape(-1))
    return painted.reshape(image.shape)


def normalize_snr(snr, nsmooth_snr=1, iwa=None, owa=None, oversampling=None,
                  fast=None, fit=False, show=False):
    """Normalize an SNR map by its radial robust-std profile (vip_tpu
    andromeda.py:533). Returns (snr_norm, the profile's map) as tensors
    on the map's device.

    The ladder: from the first non-zero ring up to the first ring whose
    mean profile is 0, each ring at integer radius i gets the robust std
    of the pixels i ≤ r ≤ i + nsmooth_snr (of i ≤ r ≤ i + 1 without
    smoothing); then the outer rings are filled the way vip_tpu fills
    them: from the last non-zero pixel of the centre row, or from the
    rings that end there. Every ring's statistic comes from one masked
    sort of the map; the rings are painted in order, later ones over
    earlier ones."""
    if fit:
        raise NotImplementedError("`fit` parameter is not implemented!")
    if show:
        raise NotImplementedError("`show` parameter is not implemented!")
    snr = as_tensor(snr)
    dev, dt = snr.device, snr.dtype
    nsnr = snr.shape[1]
    xcen = ycen = (nsnr - 1) / 2
    prof_snr = couronne_img(image=snr, xcen=xcen, ycen=ycen).cpu().numpy()
    radii = torch.as_tensor(dist_matrix(nsnr, xcen, ycen), dtype=dt,
                            device=dev).reshape(-1)
    values = snr.reshape(-1)
    imaz = torch.zeros((nsnr, nsnr), dtype=dt, device=dev)

    def rings(lo, hi):
        return (torch.as_tensor(np.asarray(lo, float), dtype=dt, device=dev),
                torch.as_tensor(np.asarray(hi, float), dtype=dt, device=dev))

    def std_of(lo, hi):
        return _ring_robust_std(values, radii, *rings(lo, hi))

    def paint(image, lo, hi, vals):
        return _paint(image, radii, *rings(lo, hi), vals)

    if owa is None or oversampling is None:
        dmax = nsnr // 2
    else:
        dmax = min(int(np.ceil(owa * 2 * oversampling)), nsnr // 2)
    if iwa is None or oversampling is None:
        centre_row = snr[:, int(ycen)].cpu().numpy()
        dmin = next((dm for dm in range(nsnr // 2)
                     if centre_row[int(xcen + dm)] != 0), nsnr // 2 - 1)
    else:
        dmin = int(np.round(iwa * 2 * oversampling))

    # the rings from dmin up to the first empty profile ring j
    zero = [i for i in range(dmin, dmax) if prof_snr[i] == 0]
    j = zero[0] if zero else 0
    i1 = np.arange(dmin, zero[0] if zero else dmax)
    it_robust = torch.zeros(nsnr // 2, dtype=dt, device=dev)
    if len(i1):
        if nsmooth_snr == 0:
            imaz = paint(imaz, i1, i1 + 1, std_of(i1, i1 + 1))
        else:
            it_robust[i1] = std_of(i1, i1 + nsmooth_snr)
            imaz = paint(imaz, i1 - 0.5, i1 + 0.5, it_robust[i1])

    dfast = 450  # [px], for SPHERE-IRDIS data (vip_tpu andromeda.py:609)
    dnozero = int(np.nonzero(
        snr[int(ycen), int(xcen):].cpu().numpy())[0][-1])
    if dnozero == dmax:
        # one std over the outer rings, from dnozero - nsmooth_snr - 1
        start = dnozero - nsmooth_snr - 1
        value = std_of([start], [nsnr / 2 - 1])
        imaz = paint(imaz, [start], [nsnr / 2 - 1], value)
    elif fast and dnozero >= dfast:
        i3 = np.arange(dfast - nsmooth_snr - 1, nsnr // 2)
        value = it_robust[dnozero - nsmooth_snr - 1].expand(len(i3))
        imaz = paint(imaz, i3, i3 + 1, value)
    else:
        k = None
        for i in range(j - nsmooth_snr, dnozero):
            if prof_snr[i] != 0:
                k = i
        if k is None:
            raise RuntimeError("prof_snr is zero!")
        i4 = np.arange(j - nsmooth_snr, k)
        if len(i4):
            if nsmooth_snr == 0:
                vals = std_of(i4, i4 + 1)
                keep = ~torch.isnan(vals)
                imaz = paint(imaz, i4[keep.cpu().numpy()],
                             i4[keep.cpu().numpy()] + 1, vals[keep])
            else:
                vals = std_of(i4, np.full(len(i4), k))
                # an empty ring keeps the ladder's earlier value
                prev = it_robust[torch.as_tensor(i4, device=dev)]
                vals = torch.where(torch.isnan(vals), prev, vals)
                imaz = paint(imaz, i4 - 0.5, i4 + 0.5, vals)

    zone = imaz != 0
    snr_norm = torch.where(zone, snr / torch.where(zone, imaz, 1.0), 0.0)
    return snr_norm, imaz


def couronne_img(image, xcen, ycen=None, lieu=None, step=0.5, rmax=None,
                 verbose=False):
    """Mean radial profile of a square image: the centre pixel, then the
    mean over each ring |r - i| ≤ step (vip_tpu andromeda.py:614).
    Returns a tensor of rmax + 1 values on the image's device."""
    image = as_tensor(image)
    if image.shape[0] != image.shape[1]:
        raise ValueError("`image` should be square")
    if ycen is None:
        ycen = xcen
    if rmax is None:
        rmax = image.shape[0] // 2
    dev, dt = image.device, image.dtype
    lieu = torch.ones(image.shape, dtype=torch.bool, device=dev) \
        if lieu is None else as_tensor(np.asarray(lieu, bool), dev,
                                       torch.bool)
    tempo = torch.as_tensor(dist_matrix(image.shape[0], xcen, ycen),
                            dtype=dt, device=dev)
    i = torch.arange(1, rmax + 1, dtype=dt, device=dev)[:, None, None]
    mask = ((tempo[None] - i).abs() <= step) & lieu[None]
    count = mask.sum((1, 2))
    sums = torch.where(mask, image[None], 0.0).sum((1, 2))
    intenmoy = torch.zeros(rmax + 1, dtype=dt, device=dev)
    intenmoy[0] = image[int(ycen), int(xcen)]
    intenmoy[1:] = torch.where(count > 0, sums / count.clamp(min=1), 0.0)
    return intenmoy

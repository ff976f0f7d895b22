"""Spatial rescaling of frames and cubes (port of
``vip_tpu.preproc.rescaling``): the exact FFT zoom ``scale_fft`` and the
IFS speckle alignment ``cube_rescaling_wavelengths`` built on it.

The zoom's geometry (the integer paddings KD of the input and KF of the
spectrum that make ``scale`` a ratio of two integer canvases) is chosen
on the host, as in vip_tpu. The two FFTs run on the frames' device, and
every frame that shares a scale shares a canvas: the internal
``_zoom_batch`` zooms a whole (B, dim, dim) batch in one ``torch.fft``
call each way. ``cube_rescaling_wavelengths`` does the same over a 4-D
(channels, frames, y, x) cube through ``_scwave``, one batched zoom a
channel, and collapses the channels of all frames at once (the median
through CUDA kernel H1 on the card, one launch for the whole cube). The
uniform (dim, dim) operator of ``scale_fft_matrix`` is kept as the
second form of the same zoom.

Imlibs: 'vip-fft' on the device; 'ndimage' runs scipy on the host, frame
by frame, as vip_tpu does; 'opencv' is OpenCV's float32 ``warpAffine``
and ``resize`` as vip_tpu calls them, computed on the device by
:mod:`vip_tpu_torch.ops.warp` (the card's machine has no OpenCV).
``find_scal_vector``'s simplex and ``_find_indices_sdi`` are host numpy
and scipy, as in vip_tpu.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..config.device import as_tensor
from ..config.timing import leading_frames, traced
from ..preproc.subsampling import collapse_jax
from ..var.coords import frame_center

__all__ = ["cube_px_resampling", "frame_px_resampling", "cube_rescaling",
           "frame_rescaling", "cube_rescaling_wavelengths",
           "check_scal_vector", "find_scal_vector", "scale_fft"]

_ORDER = {"nearneig": 0, "bilinear": 1, "biquadratic": 2, "bicubic": 3,
          "biquartic": 4, "lanczos4": 4, "biquintic": 5}
_PAD = {"reflect": "reflect", "constant": "constant", "edge": "replicate",
        "wrap": "circular"}


def _str(v):
    return getattr(v, "value", v)


def _host_vec(v):
    """1-d float64 host array of a list, array or tensor."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=float)


def _check_imlib(imlib):
    imlib = _str(imlib)
    if imlib not in ("vip-fft", "ndimage", "opencv"):
        raise ValueError("Image transformation library not recognized")
    return imlib


def _cv_interp(interpolation):
    """OpenCV's interpolation of vip_tpu's name (rescaling.py:215, 507)."""
    from ..ops.warp import VIP_INTERPOLATIONS

    interpolation = _str(interpolation)
    if interpolation not in VIP_INTERPOLATIONS:
        raise NotImplementedError(
            f"imlib 'opencv': interpolation {interpolation!r} is not one of "
            f"{sorted(VIP_INTERPOLATIONS)}")
    return VIP_INTERPOLATIONS[interpolation]


def _cv_rescale(frames, scale_y, scale_x, ref_xy, interpolation):
    """vip_tpu's 'opencv' ``frame_rescaling`` (rescaling.py:212-221) of a
    (B, y, x) batch: the frames rounded to float32, OpenCV's float32
    ``warpAffine`` with the scale matrix about ``ref_xy`` and a zero
    border, divided by scale_y·scale_x; one batched warp."""
    from ..ops.warp import warp_affine

    ref_x, ref_y = ref_xy
    M = np.array([[scale_x, 0, (1.0 - scale_x) * ref_x],
                  [0, scale_y, (1.0 - scale_y) * ref_y]])
    work = frames.to(torch.float32).to(frames.dtype)
    out = warp_affine(work, M, tuple(frames.shape[-2:]),
                      _cv_interp(interpolation), "constant", "float32")
    return out / (scale_y * scale_x)


def _kdkf(dim, scale):
    """The host geometry of the FFT zoom of an even ``dim`` by ``scale``
    (vip_tpu rescaling.py:48-56): the input padding KD and the spectrum
    padding KF whose canvases ``dim + 2 KD`` and ``dim + 2 KF`` come
    nearest to the ratio ``scale``."""
    kd_array = np.arange(dim / 2 + 1, dtype=int)
    yy = dim / 2 * (scale - 1) + kd_array.astype(float) * scale
    kf_array = np.round(yy).astype(int)
    imin = np.nanargmin(np.abs(yy - kf_array))
    return int(kd_array[imin]), int(kf_array[imin])


def _dim_resc(dim, scale):
    dim_resc = int(round(scale * dim))
    if dim_resc > dim and dim_resc % 2 != dim % 2:
        dim_resc += 1
    elif dim_resc < dim and dim_resc % 2 != dim % 2:
        dim_resc -= 1
    return dim_resc


def _zoom_batch(frames, scale, ori_dim):
    """``scale_fft`` of every frame of a (B, dim, dim) tensor (even dim),
    in one forward and one inverse ``torch.fft`` call. The canvas is
    float32 whatever the input, as vip_tpu's (rescaling.py:59-62:
    ``np.zeros(..., dtype=array.dtype.kind)`` is float32), then the FFTs
    run in the frames' dtype."""
    if scale == 1:
        return frames
    B, dim = frames.shape[0], frames.shape[-1]
    kd, kf = _kdkf(dim, scale)
    dim_p = dim + 2 * kd
    dim_pp = dim + 2 * kf
    big = torch.zeros((B, dim_p, dim_p), dtype=torch.float32,
                      device=frames.device)
    big[:, kd:kd + dim, kd:kd + dim] = frames
    spec = torch.fft.fftshift(torch.fft.fft2(big.to(frames.dtype)),
                              dim=(-2, -1))
    if dim_pp > dim_p:
        off = (dim_pp - dim_p) // 2
        tmp = spec.new_zeros((B, dim_pp, dim_pp))
        tmp[:, off:off + dim_p, off:off + dim_p] = spec
    else:
        off = (dim_p - dim_pp) // 2
        tmp = spec[:, off:off + dim_pp, off:off + dim_pp]
    del spec
    out = torch.fft.ifft2(torch.fft.fftshift(tmp, dim=(-2, -1))).real
    del tmp
    dim_resc = _dim_resc(dim, scale)
    if not ori_dim and dim_pp > dim_resc:
        a = (dim_pp - dim_resc) // 2
        b = (dim_pp + dim_resc) // 2
        return out[:, a:b, a:b]
    if not ori_dim:
        res = out.new_zeros((B, dim_resc, dim_resc))
        a = (dim_resc - dim_pp) // 2
        b = (dim_resc + dim_pp) // 2
        res[:, a:b, a:b] = out
        return res
    if dim_pp > dim:
        return out[:, kf:kf + dim, kf:kf + dim]
    res = torch.zeros_like(frames)
    res[:, -kf:-kf + dim_pp, -kf:-kf + dim_pp] = out
    return res


def scale_fft(array, scale, ori_dim=False):
    """Exact FFT resampling of an even square frame by ``scale``
    (vip_tpu rescaling.py:43), on the frame's device."""
    array = as_tensor(array)
    if scale == 1:
        return array
    return _zoom_batch(array[None], scale, ori_dim)[0]


def scale_fft_matrix(dim, scale, dtype=np.float64):
    """Exact ``scale_fft(·, scale, ori_dim=True)`` as a (dim, dim) operator
    ``(R0, g, h)`` (vip_tpu rescaling.py:101): the zoom of an even square
    frame f is ``R0 f R0ᵀ − (hᵀ f h) g gᵀ`` (:func:`apply_scale_matrix`).
    Host numpy in float64 (vip_tpu's form of the same zoom; the port's
    paths use the batched FFT form, which also keeps vip_tpu's float32
    canvas)."""
    if dim % 2:
        raise ValueError("scale_fft_matrix requires an even dim")
    if scale == 1:
        z = np.zeros(dim, dtype=dtype)
        return np.eye(dim, dtype=dtype), z, z
    kd, kf = _kdkf(dim, scale)
    dim_p = dim + 2 * kd
    dim_pp = dim + 2 * kf
    dmin = min(dim_p, dim_pp)
    k = np.arange(-(dmin // 2), dmin // 2, dtype=np.float64)
    m = np.arange(dim, dtype=np.float64)
    u = m + kf
    E_out = np.exp(2j * np.pi * np.outer(u, k) / dim_pp)
    E_in = np.exp(-2j * np.pi * np.outer(k, m + kd) / dim_p)
    R0 = np.real(E_out @ E_in) / dim_pp
    k0 = -(dmin // 2)
    a = np.exp(2j * np.pi * k0 * u / dim_pp)
    b = np.exp(-2j * np.pi * k0 * (m + kd) / dim_p)
    if dmin == dim_p:
        g = np.imag(a) / dim_pp
        h = np.where((m.astype(int) + kd) % 2 == 0, 1.0, -1.0)
    else:
        g = np.where((m.astype(int) + kf) % 2 == 0, 1.0, -1.0) / dim_pp
        h = np.imag(b)
    invalid = (u < 0) | (u >= dim_pp)
    R0[invalid] = 0.0
    g = np.where(invalid, 0.0, g)
    return (np.ascontiguousarray(R0, dtype=dtype), g.astype(dtype),
            h.astype(dtype))


def apply_scale_matrix(frame, R0, g, h):
    """Apply a :func:`scale_fft_matrix` operator to a square frame, or to
    each frame of a (..., dim, dim) tensor batch:
    ``R0 f R0ᵀ − (hᵀ f h) g gᵀ`` (vip_tpu rescaling.py:161)."""
    if isinstance(frame, torch.Tensor):
        R0, g, h = (as_tensor(v, frame.device, frame.dtype)
                    for v in (R0, g, h))
        corr = torch.einsum("i,...ij,j->...", h, frame, h)
        return R0 @ frame @ R0.T - corr[..., None, None] * torch.outer(g, g)
    corr = h @ frame @ h
    return R0 @ frame @ R0.T - corr * g[:, None] * g[None, :]


def _nan_prepare(frames):
    """VIP's NaN handling of a (B, y, x) batch: NaNs take their frame's
    nanmedian, and the returned 0/1 mask (None without NaN) marks them."""
    nan = torch.isnan(frames)
    if not bool(nan.any()):
        return frames, None
    from ..ops.median import nanmedian_plain

    med = nanmedian_plain(frames.reshape(frames.shape[0], -1), 1)
    frames = torch.where(nan, med[:, None, None], frames)
    return frames, nan.to(frames.dtype)


def _even_embed(frames):
    """An odd (B, n, n) batch embedded at [1:, 1:] of an even canvas."""
    out = frames.new_zeros((frames.shape[0], frames.shape[1] + 1,
                            frames.shape[2] + 1))
    out[:, 1:, 1:] = frames
    return out


def _zoom_odd_aware(frames, scale, ori_dim):
    odd = bool(frames.shape[-1] % 2)
    if odd:
        frames = _even_embed(frames)
    out = _zoom_batch(frames, scale, ori_dim)
    return out[:, 1:, 1:] if odd else out


def _ndimage_rescale(frames, scale_y, scale_x, ref_xy, order):
    """scipy's ``geometric_transform`` of each frame on the host (VIP's
    'ndimage' rescaling), back on the frames' device."""
    from scipy.ndimage import geometric_transform

    ref_x, ref_y = ref_xy

    def _scale_func(output_coords):
        return (ref_y + (output_coords[0] - ref_y) / scale_y,
                ref_x + (output_coords[1] - ref_x) / scale_x)

    host = frames.detach().cpu().numpy().astype(float)
    out = np.stack([geometric_transform(fr, _scale_func, order=order,
                                        output_shape=fr.shape)
                    for fr in host]) / (scale_y * scale_x)
    return torch.as_tensor(out, dtype=frames.dtype, device=frames.device)


def _rescale_batch(frames, scale, ref_xy, imlib, interpolation):
    """``frame_rescaling`` of every frame of a (B, y, x) batch by one
    scale, about ``ref_xy`` (the frame center for 'vip-fft')."""
    imlib = _check_imlib(imlib)
    frames, mask = _nan_prepare(frames)
    if imlib in ("ndimage", "opencv"):
        if ref_xy is None:
            ref_xy = frame_center(frames[0])
        if imlib == "opencv":
            out = _cv_rescale(frames, scale, scale, ref_xy, interpolation)
        else:
            out = _ndimage_rescale(frames, scale, scale, ref_xy,
                                   _ORDER[_str(interpolation)])
    else:
        if frames.shape[-2] != frames.shape[-1]:
            raise ValueError("FFT scaling only supports square input arrays")
        if mask is not None:
            mask = _zoom_odd_aware(mask, scale, True)
        out = _zoom_odd_aware(frames, scale, True)
    if mask is not None:
        out = torch.where(mask >= 0.5, torch.nan, out)
    return out


def frame_rescaling(array, ref_xy=None, scale=1.0, imlib="vip-fft",
                    interpolation="lanczos4", scale_y=None, scale_x=None):
    """Rescale a frame about a reference point, keeping its shape (vip_tpu
    rescaling.py:168). Returns a tensor on the frame's device."""
    array = as_tensor(array).clone()
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array.")
    scale_y = scale if scale_y is None else scale_y
    scale_x = scale if scale_x is None else scale_x
    imlib = _check_imlib(imlib)
    if ref_xy is not None and imlib == "vip-fft" \
            and tuple(ref_xy) != frame_center(array):
        raise ValueError("'vip-fft' imlib does not yet allow for custom "
                         "center to be provided")
    if imlib in ("ndimage", "opencv"):
        frames, mask = _nan_prepare(array[None])
        if ref_xy is None:
            ref_xy = frame_center(array)
        if imlib == "opencv":
            out = _cv_rescale(frames, scale_y, scale_x, ref_xy,
                              interpolation)
        else:
            out = _ndimage_rescale(frames, scale_y, scale_x, ref_xy,
                                   _ORDER[_str(interpolation)])
        if mask is not None:
            out = torch.where(mask >= 0.5, torch.nan, out)
        return out[0]
    if scale_x != scale_y:
        raise ValueError("FFT scaling only supports identical factors along "
                         "x and y")
    return _rescale_batch(array[None], scale_x, None, imlib,
                          interpolation)[0]


def cube_rescaling(array, scaling_list, ref_xy=None, imlib="vip-fft",
                   interpolation="lanczos4", scaling_y=None, scaling_x=None,
                   nproc=1):
    """Rescale each frame of a cube by its own factor (vip_tpu
    rescaling.py:259); frames of equal factor go through one batched
    zoom. Returns a tensor on the cube's device."""
    array = as_tensor(array)
    if array.ndim != 3:
        raise TypeError("Input array is not a cube or 3d array")
    n = array.shape[0]
    if scaling_list is None:
        scaling_list = [None] * n
    scales = [None if s is None else float(s) for s in
              (_host_vec(scaling_list) if not isinstance(scaling_list, list)
               else scaling_list)]
    out = None
    for s in dict.fromkeys(scales):
        idx = [i for i in range(n) if scales[i] == s]
        if s is None and scaling_y is None and scaling_x is None:
            raise TypeError("a scaling factor is needed for every frame")
        if s is None or scaling_y is not None or scaling_x is not None:
            res = torch.stack([frame_rescaling(
                array[i], ref_xy=ref_xy, scale=s, imlib=imlib,
                interpolation=interpolation, scale_y=scaling_y,
                scale_x=scaling_x) for i in idx])
        else:
            if ref_xy is not None and _str(imlib) == "vip-fft" \
                    and tuple(ref_xy) != frame_center(array[0]):
                raise ValueError("'vip-fft' imlib does not yet allow for "
                                 "custom center to be provided")
            res = _rescale_batch(array[idx], s, ref_xy, imlib, interpolation)
        if out is None:
            out = array.new_empty((n,) + tuple(res.shape[1:]))
        out[idx] = res
    return out


def _square_bounds(size_init, size, y, x):
    """(y0, y1, x0, x1) of ``get_square``'s crop of ``size`` about (y, x)
    in a frame of ``size_init`` px (the size takes the frame's parity)."""
    if size_init % 2 == 0 and size % 2 != 0:
        size += 1
    elif size_init % 2 != 0 and size % 2 == 0:
        size += 1
    wing = (size - 1) / 2
    return int(y - wing), int(y + wing + 1), int(x - wing), int(x + wing + 1)


@traced("rescaling.scwave", leading_frames)
def _scwave(cube, scal_list, full_output=True, inverse=False, y_in=None,
            x_in=None, imlib="vip-fft", interpolation="lanczos4",
            collapse="median", pad_mode="reflect", keep_cube=True):
    """``cube_rescaling_wavelengths`` of a (z, B, y, x) tensor: the B
    frames of each channel zoom in one batched call, and the channels of
    all B frames collapse at once (z, B·y, x). Returns (cube_out (z, B, Y,
    X) or None without ``keep_cube``, frames (B, Y', X') or None with
    ``collapse=None``, y, x, cy, cx)."""
    z, B, y, x = cube.shape
    scal_list = _host_vec(scal_list)
    max_sc = np.amax(scal_list)
    imlib = _check_imlib(imlib)
    if not inverse and max_sc > 1:
        new_y = int(np.ceil(max_sc * y))
        new_x = int(np.ceil(max_sc * x))
        if (new_y - y) % 2 != 0:
            new_y += 1
        if (new_x - x) % 2 != 0:
            new_x += 1
        py = (new_y - y) // 2
        px = (new_x - x) // 2
        mode = _PAD.get(pad_mode)
        if mode is None:
            raise ValueError(f"pad_mode {pad_mode!r} not supported: one of "
                             f"{sorted(_PAD)}")
        if mode == "reflect" and (py >= y or px >= x):
            raise ValueError("pad_mode 'reflect' needs a pad smaller than the"
                             " frame: scale factors up to 3")
        big = F.pad(cube, (px, px, py, py), mode=mode)
    else:
        big = cube
    _, _, y, x = big.shape
    cy, cx = frame_center(big[0, 0])
    scales = 1.0 / scal_list if inverse else scal_list
    if inverse:
        cy, cx = frame_center(cube[0, 0])
    out = None
    for ch in range(z):
        res = _rescale_batch(big[ch], float(scales[ch]), (cx, cy), imlib,
                             interpolation)
        if out is None:
            out = big.new_empty((z,) + tuple(res.shape))
        out[ch] = res
    del big
    crop = None
    if inverse and max_sc > 1:
        if y_in is None or x_in is None:
            raise ValueError("Provide y_in and x_in when inverse=True")
        siz = max(y_in, x_in)
        if y > siz:
            crop = _square_bounds(y, siz, cy, cx)
    if crop is not None:
        y0, y1, x0, x1 = crop
        out = out[..., y0:y1, x0:x1]
    Y, X = out.shape[-2:]
    frames = None
    if collapse is not None:
        frames = collapse_jax(out.reshape(z, B * Y, X).contiguous(),
                              mode=_str(collapse), ax=0).reshape(B, Y, X)
    if not (full_output and keep_cube):
        out = None
    return out, frames, y, x, cy, cx


def cube_rescaling_wavelengths(cube, scal_list, full_output=True,
                               inverse=False, y_in=None, x_in=None,
                               imlib="vip-fft", interpolation="lanczos4",
                               collapse="median", pad_mode="reflect",
                               nproc=1):
    """Rescale the spectral channels of a (z, y, x) cube to align the
    speckles, or the inverse (vip_tpu rescaling.py:278). Returns
    (cube_out, frame, y, x, cy, cx) with ``full_output``, else the frame,
    as tensors on the cube's device. ``pad_mode`` is numpy's name
    ('reflect', 'constant', 'edge', 'wrap'); 'reflect' takes scale factors
    up to 3 (a pad smaller than the frame)."""
    cube = as_tensor(cube)
    out, frames, y, x, cy, cx = _scwave(
        cube[:, None], scal_list, full_output, inverse, y_in, x_in, imlib,
        interpolation, collapse, pad_mode)
    if full_output:
        return out[:, 0], frames[0], y, x, cy, cx
    return frames[0]


def check_scal_vector(scal_vec):
    """Scaling factors normalized so that the smallest is 1 (vip_tpu
    rescaling.py:334). Host numpy."""
    if isinstance(scal_vec, torch.Tensor):
        scal_vec = scal_vec.detach().cpu().numpy()
    if not isinstance(scal_vec, (list, np.ndarray)):
        raise TypeError("`Scal_vec` is neither a list or an np.ndarray")
    scal_vec = np.array(scal_vec)
    if scal_vec.min() != 1:
        scal_vec = scal_vec / scal_vec.min()
    return scal_vec


def _chisquare_scal(modelParameters, cube, flux_fac=1, mask=None, fm="sum",
                    imlib="vip-fft", interpolation="lanczos4"):
    """χ² of the difference between channel 0 scaled (and flux-scaled) and
    channel 1 (vip_tpu rescaling.py:348); a host float."""
    array = as_tensor(cube).clone()
    (scale_fac,) = modelParameters
    array[0] = array[0] * flux_fac
    array = cube_rescaling(array, np.array([scale_fac, 1]), imlib=imlib,
                           interpolation=interpolation)
    frame = array[1] - array[0]
    if mask is None:
        values = frame.reshape(-1)
    else:
        values = frame[as_tensor(np.asarray(mask) != 0, frame.device,
                                 torch.bool)]
    if fm == "sum":
        return float(torch.sum(values ** 2))
    elif fm == "stddev":
        values = values[values != 0]
        return float(torch.std(values, correction=0))
    raise RuntimeError("fm choice not recognized.")


def _chisquare_scal_2fp(modelParameters, cube, mask=None, fm="sum",
                        imlib="vip-fft", interpolation="lanczos4"):
    """χ² with two free parameters, scale and flux (vip_tpu
    rescaling.py:368)."""
    scale_fac, flux_fac = modelParameters
    return _chisquare_scal((scale_fac,), cube, flux_fac, mask, fm, imlib,
                           interpolation)


def find_scal_vector(cube, lbdas, fluxes, mask=None, nfp=2, fm='stddev',
                     simplex_options=None, debug=False, imlib="vip-fft",
                     interpolation="lanczos4", hpf=False, fwhm_max=5,
                     **kwargs):
    """Per-channel scaling (and flux) factors by a Nelder-Mead simplex on
    the χ² of each channel against the last (vip_tpu rescaling.py:375):
    scipy on the host, each χ² a zoom on the cube's device. Returns host
    numpy (scal_vec, flux_vec)."""
    from scipy.optimize import minimize

    lbdas = _host_vec(lbdas)
    fluxes = _host_vec(fluxes)
    scal_vec_ini = lbdas[-1] / lbdas
    n_z = len(lbdas)
    if n_z != len(fluxes) or n_z != cube.shape[0]:
        raise TypeError("first axis of cube, fluxes and lbda must have same "
                        "length")
    if simplex_options is None:
        simplex_options = {"xatol": 1e-6, "fatol": 1e-6, "maxiter": 800,
                           "maxfev": 2000}
    scal_vec = np.ones(n_z)
    flux_vec = np.ones(n_z)
    array = as_tensor(cube)
    if hpf:
        from ..var.filters import cube_filter_highpass

        med_sz = int(5 * fwhm_max)
        if not med_sz % 2:
            med_sz += 1
        array = cube_filter_highpass(array, mode="median-subt",
                                     median_size=med_sz)
    for z in range(n_z - 1):
        flux_scal = fluxes[-1] / fluxes[z]
        cube_tmp = torch.stack([array[z], array[-1]])
        if nfp == 1:
            solu = minimize(_chisquare_scal, (scal_vec_ini[z],),
                            args=(cube_tmp, flux_scal, mask, fm, imlib,
                                  interpolation),
                            method="Nelder-Mead", bounds=((1e-1, None),),
                            options=simplex_options, **kwargs)
            (scal_fac,) = solu.x
            flux_fac = flux_scal
        else:
            solu = minimize(_chisquare_scal_2fp,
                            (scal_vec_ini[z], flux_scal),
                            args=(cube_tmp, mask, fm, imlib, interpolation),
                            method="Nelder-Mead",
                            bounds=((1e-1, None), (1e-2, None)),
                            options=simplex_options, **kwargs)
            scal_fac, flux_fac = solu.x
        if debug:
            print(f"channel {z}:", solu.x)
        scal_vec[z] = scal_fac
        flux_vec[z] = flux_fac
    return check_scal_vector(scal_vec), flux_vec


def _find_indices_sdi(scal, dist, index_ref, fwhm, delta_sep=1, nframes=None,
                      debug=False):
    """Channels far enough from ``index_ref`` in radial motion to limit
    the SDI self-subtraction at separation ``dist`` (vip_tpu
    rescaling.py:433). Host numpy."""
    scal = _host_vec(scal)
    scal_ref = scal[index_ref]
    sep_lft = (scal_ref - scal) / scal_ref * ((dist + fwhm * delta_sep)
                                              / fwhm)
    sep_rgt = (scal - scal_ref) / scal_ref * ((dist - fwhm * delta_sep)
                                              / fwhm)
    map_lft = sep_lft >= delta_sep
    map_rgt = sep_rgt >= delta_sep
    indices = np.nonzero(map_lft | map_rgt)[0]
    if debug:
        print(f"dist: {dist}, index_ref: {index_ref}")
    if indices.size == 0:
        raise RuntimeError("No frames left after radial motion threshold. "
                           "Try decreasing the value of `delta_sep`")
    if nframes is not None:
        i1 = map_lft.sum()
        window = nframes // 2
        if i1 - window < 0 or i1 + window > indices[-1]:
            window = nframes
        ind1 = max(0, i1 - window)
        ind2 = min(scal.size, i1 + window)
        indices = indices[ind1:ind2]
        if indices.size < 2:
            raise RuntimeError("No frames left after radial motion "
                               "threshold. Try decreasing the value of "
                               "`delta_sep` or `nframes`")
    return indices


def _resample_batch(frames, scale_y, scale_x, imlib, interpolation):
    """``frame_px_resampling`` of every frame of a (B, y, x) batch."""
    imlib = _check_imlib(imlib)
    frames, mask = _nan_prepare(frames)
    if imlib == "ndimage":
        from scipy.ndimage import zoom

        order = _ORDER[_str(interpolation)]
        host = frames.detach().cpu().numpy().astype(float)
        out = np.stack([zoom(fr, zoom=(scale_y, scale_x), order=order)
                        for fr in host]) / (scale_y * scale_x)
        out = torch.as_tensor(out, dtype=frames.dtype, device=frames.device)
        if mask is not None:
            m = mask.detach().cpu().numpy()
            mask = torch.as_tensor(
                np.stack([zoom(fr, zoom=(scale_y, scale_x), order=order)
                          for fr in m]), dtype=frames.dtype,
                device=frames.device)
    elif imlib == "opencv":
        # vip_tpu rescaling.py:504-515: cv2.resize of the float32 frame
        # (and of the float32 mask), then divided in float64
        from ..ops.warp import resize

        intp = _cv_interp(interpolation)
        if mask is not None:
            mask = resize(mask, scale_x, scale_y, intp)
        out = resize(frames.to(torch.float32).to(frames.dtype), scale_x,
                     scale_y, intp)
        out = out.to(torch.float32).to(frames.dtype) / (scale_y * scale_x)
    else:
        if scale_x != scale_y:
            raise ValueError("FFT scaling only supports identical factors")
        if frames.shape[-2] != frames.shape[-1]:
            raise ValueError("FFT scaling only supports square input arrays")
        if mask is not None:
            mask = _zoom_odd_aware(mask, scale_x, False)
        out = _zoom_odd_aware(frames, scale_x, False)
    if mask is not None and mask.shape == out.shape:
        out = torch.where(mask >= 0.5, torch.nan, out)
    return out


def _px_scales(scale):
    if isinstance(scale, tuple):
        return scale[1], scale[0]
    if isinstance(scale, (float, int, np.floating, np.integer)):
        return scale, scale
    raise TypeError("`scale` must be float, int or tuple")


def frame_px_resampling(array, scale, imlib="vip-fft",
                        interpolation="lanczos4", keep_center=False,
                        verbose=False):
    """Resample a frame to new dimensions by ``scale`` (a factor or
    (scale_x, scale_y); vip_tpu rescaling.py:469). Returns a tensor on the
    frame's device."""
    array = as_tensor(array)
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array")
    scale_y, scale_x = _px_scales(scale)
    out = _resample_batch(array[None], scale_y, scale_x, imlib,
                          interpolation)[0]
    if verbose:
        print(f"Image successfully rescaled. New shape: {tuple(out.shape)}")
    return out


def cube_px_resampling(array, scale, imlib="vip-fft",
                       interpolation="lanczos4", keep_center=False,
                       verbose=True):
    """Resample every frame of a cube by ``scale`` (vip_tpu
    rescaling.py:550), all frames in one batched zoom. Returns a tensor on
    the cube's device."""
    array = as_tensor(array)
    if array.ndim != 3:
        raise TypeError("Input array is not a cube or 3d array.")
    scale_y, scale_x = _px_scales(scale)
    out = _resample_batch(array, scale_y, scale_x, imlib, interpolation)
    if verbose:
        print("Cube successfully rescaled")
        print(f"New shape: {tuple(out.shape)}")
    return out

"""Frame and cube derotation (port of ``vip_tpu.preproc.derotation``).

VIP's exact rotation ('vip-fft'): the frame sits in a ~1.5x
parity-preserving canvas inside a ~4x zero canvas, rotates by three FFT
shears and is cropped back (vip_hci/preproc/derotation.py:129-217). Every
exact rotation goes through :func:`vip_tpu_torch.ops.shear.rotate_exact`
(CUDA kernel H2 where its gate holds). With ``edge_blend`` the ~1.5x
canvas carries noise or a smooth extension of the frame, so the whole 4x
canvas rotates (:func:`vip_tpu_torch.ops.fft.rotate_fft_batch`).

'opencv' and 'skimage' are OpenCV's ``warpAffine`` as vip_tpu calls it
(float32 and float64 inputs take different OpenCV code paths), computed
on the tensor's device by :mod:`vip_tpu_torch.ops.warp`; 'tpu-interp' is
vip_tpu's own gather rotation (:mod:`vip_tpu_torch.ops.interp_rotation`).
A cube is rotated in one batched call, never a loop over frames. The
PA-threshold library selection helpers are host-side numpy, as in
vip_tpu. ``tensor_fft_shear`` and ``tensor_rotate_fft`` are VIP's own
torch three-shear rotation of one (1, y, x) frame, kept with its quirks
and its own geometry, in plain ``torch.fft``.
"""

import math

import numpy as np
import torch

from ..config.device import as_tensor, get_device
from ..config.timing import leading_frames, traced
from ..ops.fft import rotate_fft, rotate_fft_batch, rotate_fft_exact_pruned
from ..ops.shear import rotate_exact
from ..ops.warp import VIP_INTERPOLATIONS, rotation_matrix, warp_affine
from ..var.coords import frame_center

__all__ = ["cube_derotate", "frame_rotate", "rotate_fft_pipeline",
           "rotate_fft_pruned_batch"]


# ---------------------------------------------------------------------------
# geometry of the vip-fft padding pipeline (all static Python ints)
# ---------------------------------------------------------------------------
def _prepad_placement(y_ori, x_ori, fac=1.5):
    """Dims of the intermediate ~1.5x parity-preserving canvas and the
    slice where the original frame sits (vip_tpu derotation.py:37)."""
    cy_ori = int(y_ori / 2 - 0.5) if y_ori % 2 else int(y_ori / 2)
    cx_ori = int(x_ori / 2 - 0.5) if x_ori % 2 else int(x_ori / 2)
    new_y = int(y_ori * fac)
    new_x = int(x_ori * fac)
    if y_ori % 2 != new_y % 2:
        new_y += 1
    if x_ori % 2 != new_x % 2:
        new_x += 1
    cy = int(new_y / 2 - 0.5) if new_y % 2 else int(new_y / 2)
    cx = int(new_x / 2 - 0.5) if new_x % 2 else int(new_x / 2)
    y0_p = int(cy - cy_ori)
    y1_p = int(cy + cy_ori)
    if new_y % 2:
        y1_p += 1
    x0_p = int(cx - cx_ori)
    x1_p = int(cx + cx_ori)
    if new_x % 2:
        x1_p += 1
    return new_y, new_x, y0_p, y1_p, x0_p, x1_p


def _fft_rotate_geometry(y_ori, x_ori):
    """Pad geometry of VIP's frame_rotate (vip_tpu derotation.py:61-103).

    Returns (canvas_y, canvas_x, place_y0, place_x0, crop_y0, crop_y1,
    crop_x0, crop_x1): the final ~4x zero canvas fed to the three shears,
    where the frame is placed, and the crop that recovers it.
    """
    fac = 1.5
    new_y, new_x, y0_p, y1_p, x0_p, x1_p = _prepad_placement(y_ori, x_ori,
                                                             fac)
    cy = int(new_y / 2 - 0.5) if new_y % 2 else int(new_y / 2)
    cx = int(new_x / 2 - 0.5) if new_x % 2 else int(new_x / 2)

    # frame_pad(fac=4/1.5, keep_parity=True)
    fac2 = 4 / fac
    pad_y = int(round(new_y * fac2))
    pad_x = int(round(new_x * fac2))
    if pad_y % 2 != new_y % 2:
        pad_y -= 1
    if pad_x % 2 != new_x % 2:
        pad_x -= 1
    cyp = int(pad_y / 2 - 0.5) if pad_y % 2 else int(pad_y / 2)
    cxp = int(pad_x / 2 - 0.5) if pad_x % 2 else int(pad_x / 2)
    py0 = int(cyp - cy)
    py1 = int(cyp + cy)
    if py1 - py0 < new_y:
        py1 += 1
    elif py1 - py0 > new_y:
        py1 -= 1
    px0 = int(cxp - cx)
    px1 = int(cxp + cx)
    if px1 - px0 < new_x:
        px1 += 1
    elif px1 - px0 > new_x:
        px1 -= 1

    place_y0 = py0 + y0_p
    place_x0 = px0 + x0_p
    return (pad_y, pad_x, place_y0, place_x0, py0 + y0_p, py0 + y1_p,
            place_x0, px0 + x1_p)


def rotate_fft_pipeline(frame, angle):
    """Single-frame rotation with the full padding pipeline (pad ~4x →
    three-shear FFT rotate → crop), unpruned (vip_tpu derotation.py:106).
    ``frame`` must be square."""
    y_ori, x_ori = frame.shape
    if y_ori != x_ori:
        raise ValueError("vip-fft rotation requires square frames")
    (pad_y, pad_x, place_y0, place_x0,
     cy0, cy1, cx0, cx1) = _fft_rotate_geometry(y_ori, x_ori)
    canvas = frame.new_zeros((pad_y, pad_x))
    canvas[place_y0:place_y0 + y_ori, place_x0:place_x0 + x_ori] = frame
    return rotate_fft(canvas, angle)[cy0:cy1, cx0:cx1]


def rotate_fft_pruned_batch(cube, angles):
    """Batched pad → three-shear rotate → crop with support pruning, on
    ``torch.fft`` (vip_tpu derotation.py:129)."""
    y, x = cube.shape[-2:]
    pad_y, _, py0, px0, cy0, cy1, cx0, cx1 = _fft_rotate_geometry(y, x)
    return rotate_fft_exact_pruned(cube, angles, pad_y, py0, px0, cy0, cy1,
                                   cx0, cx1)


def _auto_chunk(n, y, itemsize, budget_bytes=8 << 30):
    """Frame-chunk size keeping the padded complex working set of the
    plain rotation (a (4y)^2 complex canvas, its FFT scratch and float64
    phase ramps: ~6 complex canvases per frame) under ``budget_bytes``.
    8 GiB is a tenth of an 80 GB card, leaving room for the cube, the
    PCA matrices and the residuals beside it."""
    per_frame = (4 * y) ** 2 * itemsize * 2 * 6
    return int(max(1, min(n, budget_bytes // max(per_frame, 1))))


def _rotate_chunks(cube, angles, chunk):
    """rotate_exact over frame chunks of at most ``chunk`` frames."""
    n = cube.shape[0]
    if chunk is None or chunk >= n:
        return rotate_exact(cube, angles)
    out = torch.empty_like(cube)
    for s in range(0, n, chunk):
        out[s:s + chunk] = rotate_exact(cube[s:s + chunk],
                                        angles[s:s + chunk])
    return out


def frame_rotate(array, angle, imlib="vip-fft", interpolation="lanczos4",
                 cxy=None, border_mode="constant", mask_val=np.nan,
                 edge_blend=None, interp_zeros=False, ker=1, *, draws=None,
                 generator=None):
    """Rotate a 2-d frame by ``angle`` degrees counter-clockwise (vip_tpu
    derotation.py:172).

    'vip-fft': VIP's exact rotation; masked values (non-finite, or
    ``mask_val``) rotate as zeros and are reset afterwards. With
    ``edge_blend`` ('noise', 'interp' or both) the frame is first set in a
    blended ~1.5x canvas (:func:`_blend_rotate`); the noise is
    ``draws`` (standard normal, the canvas's shape) or drawn from
    ``generator`` (default: a ``torch.Generator`` seeded 0).
    'opencv' / 'skimage': OpenCV's ``warpAffine`` about ``cxy`` (default
    the frame center) as vip_tpu calls it, computed by
    :func:`vip_tpu_torch.ops.warp.warp_affine` (float32 and float64 code
    paths); ``mask_val`` and ``edge_blend`` do not apply there, as in
    vip_tpu."""
    array = as_tensor(array)
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array")
    if imlib == "vip-fft":
        if cxy is not None and tuple(cxy)[::-1] != frame_center(array):
            raise ValueError("'vip-fft' imlib does not allow custom centers")
        angles = np.asarray([float(angle)])
        if edge_blend:
            if draws is not None:
                draws = as_tensor(draws, array.device, array.dtype)[None]
            return _blend_rotate(array[None], angles, mask_val, edge_blend,
                                 interp_zeros, ker, draws, generator)[0]
        mask = _mask_of(array, mask_val)
        work = torch.nan_to_num(array)
        out = rotate_exact(work[None], torch.as_tensor(angles))[0]
        return out.masked_fill(mask, mask_val)
    if imlib in ("opencv", "skimage"):
        return _warp_rotate(array[None], [float(angle)], imlib,
                            interpolation, cxy, border_mode)[0]
    raise ValueError(f"imlib {imlib!r} not supported (use 'vip-fft', "
                     "'opencv' or 'skimage')")


# vip_tpu's names of OpenCV's interpolations and borders for rotations
# (derotation.py:214-222)
_CV_INTERP = dict(VIP_INTERPOLATIONS, biquadratic="cubic",
                  biquartic="lanczos4", biquintic="lanczos4")
_CV_BORDER = {"constant": "constant", "edge": "replicate",
              "symmetric": "reflect", "reflect": "reflect101",
              "wrap": "wrap"}


def _warp_rotate(cube, angles, imlib, interpolation, cxy, border_mode):
    """Frame i of a (n, y, x) tensor rotated by ``angles[i]`` (degrees,
    counter-clockwise) about ``cxy`` (default the frame center) as
    vip_tpu's 'opencv' (float32: the frames are rounded to float32 first)
    or 'skimage' (float64) imlib calls OpenCV's ``warpAffine``: one
    batched :func:`~vip_tpu_torch.ops.warp.warp_affine`."""
    if interpolation not in _CV_INTERP:
        raise NotImplementedError(
            f"imlib {imlib!r}: interpolation {interpolation!r} is not one of "
            f"{sorted(_CV_INTERP)}")
    if border_mode not in _CV_BORDER:
        raise NotImplementedError(
            f"imlib {imlib!r}: border mode {border_mode!r} is not one of "
            f"{sorted(_CV_BORDER)}")
    n, y, x = cube.shape
    if cxy is None:
        cy, cx = frame_center((y, x))
    else:
        cx, cy = cxy
    path = "float32" if imlib == "opencv" else "float64"
    if path == "float32":
        cube = cube.to(torch.float32).to(cube.dtype)
    M = rotation_matrix(cx, cy, np.broadcast_to(
        np.asarray(angles, np.float64), (n,)))
    return warp_affine(cube, M, (y, x), _CV_INTERP[interpolation],
                       _CV_BORDER[border_mode], path)


def _mask_of(array, mask_val):
    if np.isnan(mask_val):
        return ~torch.isfinite(array)
    return array == mask_val


def _nanstd_rows(v):
    """np.std (ddof 0) of the finite values of each row of (B, P)."""
    fin = torch.isfinite(v)
    c = fin.sum(1)
    z = torch.where(fin, v, 0.0)
    m = z.sum(1) / c
    d = torch.where(fin, v - m[:, None], 0.0)
    return torch.sqrt((d * d).sum(1) / c)


def _background_med_std(values, sigma=1.5, max_iter=5):
    """Median and std of the finite values of each frame of (B, ...) after
    iterative sigma clipping about the median (vip_tpu derotation.py:
    249): a frame stops when a pass keeps all its values or none; frames
    that stopped keep their values while the others go on. (B,) each."""
    from ..ops.median import nanmedian_plain

    v = values.reshape(values.shape[0], -1).clone()
    active = torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
    for _ in range(max_iter):
        med, std = nanmedian_plain(v, 1), _nanstd_rows(v)
        fin = torch.isfinite(v)
        keep = fin & ((v - med[:, None]).abs() < sigma * std[:, None])
        stop = (keep == fin).all(1) | ~keep.any(1)
        active = active & ~stop
        if not bool(active.any()):
            break
        v = torch.where(active[:, None] & ~keep, float("nan"), v)
    return nanmedian_plain(v, 1), _nanstd_rows(v)


def _masked_gauss_smooth(sparse, fwhm):
    """NaN-aware gaussian smoothing of (B, y, x) frames, one batched FFT
    convolution each of the values and of their coverage (vip_tpu
    derotation.py:308): (smooth, covered), ``covered`` False where the
    valid pixels contribute negligible kernel weight (< 1e-8). The
    convolutions run in float64 whatever the frames' dtype: a float32 FFT
    leaves ~1e-7 of rounding in the coverage far beyond the kernel's
    reach, which the 1e-8 threshold would take for weight."""
    from ..var.filters import (GAUSSIAN_FWHM_TO_SIGMA, _fft_convolve_same,
                               gaussian_kernel_2d)

    sigma = fwhm * GAUSSIAN_FWHM_TO_SIGMA
    kernel = torch.as_tensor(gaussian_kernel_2d(sigma, sigma),
                             dtype=torch.float64, device=sparse.device)
    finite = torch.isfinite(sparse)
    values = torch.where(finite, sparse, 0.0).to(torch.float64)
    num = _fft_convolve_same(values, kernel)
    den = _fft_convolve_same(finite.to(torch.float64), kernel)
    covered = den > 1e-8
    smooth = torch.where(covered, num / torch.where(covered, den, 1.0), 0.0)
    return smooth.to(sparse.dtype), covered


def _edge_blend_canvas(frame_nan, mode, ker, draws, generator):
    """The ~1.5x Gibbs-mitigation canvases of (B, y, x) frames carrying
    NaN at every invalid pixel (vip_tpu derotation.py:263): 'noise' fills
    the ring with sigma-clipped background noise (``level + std · z``, z
    standard normal from ``draws`` or ``generator``), 'interp' extends the
    frame smoothly into the ring with a NaN-aware gaussian convolution;
    with both, the smooth halo rides on zero-mean noise. Returns the
    canvases and the (y0, x0) of the frame in them."""
    B, y_ori, x_ori = frame_nan.shape
    new_y, new_x, y0, y1, x0, x1 = _prepad_placement(y_ori, x_ori)
    dev, dt = frame_nan.device, frame_nan.dtype
    holes = ~torch.isfinite(frame_nan)
    with_noise = "noise" in mode
    with_interp = "interp" in mode

    if with_noise:
        med, std = _background_med_std(frame_nan)
        level = torch.zeros_like(med) if with_interp else med
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            draws = torch.randn((B, new_y, new_x), generator=generator,
                                dtype=dt, device=generator.device)
        z = torch.as_tensor(draws, dtype=dt).to(dev)
        canvas = level[:, None, None] + std[:, None, None] * z
    else:
        canvas = frame_nan.new_zeros((B, new_y, new_x))
    interior = canvas[:, y0:y1, x0:x1]
    canvas[:, y0:y1, x0:x1] = torch.where(holes, interior, frame_nan)

    if with_interp:
        sparse = torch.full((B, new_y, new_x), float("nan"), dtype=dt,
                            device=dev)
        sparse[:, y0:y1, x0:x1] = frame_nan
        halo, covered = _masked_gauss_smooth(sparse, ker if ker
                                             else y_ori / 5)
        ring = torch.ones((new_y, new_x), dtype=torch.bool, device=dev)
        ring[y0:y1, x0:x1] = False
        hole_canvas = torch.zeros((B, new_y, new_x), dtype=torch.bool,
                                  device=dev)
        hole_canvas[:, y0:y1, x0:x1] = holes
        if with_noise:
            local, local_cov = _masked_gauss_smooth(sparse, 1)
            canvas = torch.where(hole_canvas,
                                 torch.where(local_cov, local, 0.0), canvas)
            # beyond the kernel's reach the reference ends at 0
            canvas = torch.where(ring, torch.where(covered, canvas + halo,
                                                   0.0), canvas)
        else:
            canvas = torch.where(ring | hole_canvas,
                                 torch.where(covered, halo, 0.0), canvas)
    canvas = torch.where(torch.isfinite(canvas), canvas, 0.0)
    return canvas, (y0, x0)


def _blend_rotate(frames, angles, mask_val, mode, interp_zeros, ker, draws,
                  generator, chunk=None):
    """'vip-fft' rotation of (B, y, x) frames by ``angles`` (degrees,
    host) with the ``edge_blend`` prepad (vip_tpu derotation.py:320): the
    blended ~1.5x canvases are set in the ~4x zero canvas and rotated whole
    by :func:`vip_tpu_torch.ops.fft.rotate_fft_batch` (unpruned: the ring
    is not zero), in chunks of ``chunk`` frames ('auto' or None:
    :func:`_auto_chunk`); masked pixels get ``mask_val`` back."""
    B, y, x = frames.shape
    (pad_y, pad_x, place_y0, place_x0,
     cy0, cy1, cx0, cx1) = _fft_rotate_geometry(y, x)
    if chunk in (None, "auto"):
        chunk = _auto_chunk(B, y, frames.element_size())
    angles = np.broadcast_to(np.asarray(angles, np.float64), (B,))
    if draws is None and "noise" in mode and generator is None:
        generator = torch.Generator(device=frames.device).manual_seed(0)
    out = torch.empty_like(frames)
    for s in range(0, B, chunk):
        e = min(B, s + chunk)
        fr = frames[s:e]
        mask = _mask_of(fr, mask_val)
        fnan = fr.masked_fill(mask, float("nan"))
        if interp_zeros:
            fnan = fnan.masked_fill(fnan == 0, float("nan"))
        canvas, (y0, x0) = _edge_blend_canvas(
            fnan, mode, ker, None if draws is None else draws[s:e],
            generator)
        big = fr.new_zeros((e - s, pad_y, pad_x))
        by0, bx0 = place_y0 - y0, place_x0 - x0
        big[:, by0:by0 + canvas.shape[1], bx0:bx0 + canvas.shape[2]] = canvas
        del canvas
        rot = rotate_fft_batch(big, torch.tensor(angles[s:e]))
        out[s:e] = rot[:, cy0:cy1, cx0:cx1].masked_fill(mask, mask_val)
    return out


@traced("derotation.cube_derotate", leading_frames)
def cube_derotate(array, angle_list, imlib="vip-fft",
                  interpolation="lanczos4", cxy=None, nproc=1,
                  border_mode="constant", mask_val=np.nan, edge_blend=None,
                  interp_zeros=False, ker=1, chunk="auto", *, draws=None,
                  generator=None):
    """Derotate an ADI cube: frame i is rotated by ``-angle_list[i]``
    (vip_tpu derotation.py:344-422). Returns a tensor on the cube's device.

    - 'vip-fft': the exact rotation in chunks of ``chunk`` frames ('auto':
      :func:`_auto_chunk`); masked values (non-finite, or ``mask_val``)
      rotate as zeros and are reset afterwards. ``edge_blend`` blends each
      frame's ~1.5x canvas first (:func:`frame_rotate`), all frames at
      once: ``draws`` (n, canvas y, canvas x) or ``generator`` as there.
    - 'vip-fft-small': the packed speed mode on a 1.25x canvas restricted
      to the inscribed circle (odd or non-square frames take 'vip-fft').
    - 'opencv' / 'skimage': OpenCV's ``warpAffine`` as vip_tpu calls it
      (:func:`frame_rotate`), every frame in one batched warp.
    - 'tpu-interp': vip_tpu's own bilinear ('bilinear') or bicubic (any
      other ``interpolation``) rotation,
      :func:`vip_tpu_torch.ops.interp_rotation.rotate_interp_batch`.

    ``nproc`` is accepted for API parity and ignored.
    """
    from ..ops.interp_rotation import rotate_interp_batch
    from ..ops.pipeline import _derotate_frames

    array = as_tensor(array)
    n = array.shape[0]
    angles = as_tensor(angle_list, array.device, array.dtype)
    if angles.ndim == 0:
        angles = angles.expand(n)
    if angles.shape[0] != n:
        raise ValueError("angle_list length must match the cube")
    if imlib == "vip-fft-small" and (array.shape[-1] % 2 != 0
                                     or array.shape[-2] != array.shape[-1]):
        imlib = "vip-fft"  # speed mode needs even square frames
    if edge_blend and imlib == "vip-fft":
        host = -angles.detach().cpu().to(torch.float64).numpy()
        if draws is not None:
            draws = as_tensor(draws, array.device, array.dtype)
        return _blend_rotate(array, host, mask_val, edge_blend, interp_zeros,
                             ker, draws, generator, chunk)

    if imlib == "vip-fft":
        if chunk == "auto":
            chunk = _auto_chunk(n, array.shape[-1], array.element_size())
        mask = _mask_of(array, mask_val)
        has_mask = bool(mask.any())
        work = array.masked_fill(mask, 0.0) if has_mask else array
        out = _rotate_chunks(work, -angles, chunk)
        return out.masked_fill(mask, mask_val) if has_mask else out
    if imlib == "vip-fft-small":
        if chunk == "auto":
            chunk = min(n, max(1, 4 * _auto_chunk(n, array.shape[-1],
                                                  array.element_size())))
        work = torch.nan_to_num(array)
        return _derotate_frames(work, angles, chunk=chunk,
                                rot_mode="fft-small")
    if imlib == "tpu-interp":
        mode = "bilinear" if interpolation == "bilinear" else "bicubic"
        return rotate_interp_batch(torch.nan_to_num(array), -angles,
                                   mode=mode)
    if imlib in ("opencv", "skimage"):
        host = -angles.detach().cpu().to(torch.float64).numpy()
        return _warp_rotate(array, host, imlib, interpolation, cxy,
                            border_mode)
    raise ValueError(f"imlib {imlib!r} not supported (use 'vip-fft', "
                     "'vip-fft-small', 'opencv', 'skimage' or 'tpu-interp')")


# ---------------------------------------------------------------------------
# PA-threshold library selection (host-side control logic)
# ---------------------------------------------------------------------------
def _find_indices_adi(angle_list, frame, thr, nframes=None, out_closest=False,
                      truncate=False, max_frames=200):
    """Indices kept in the ADI reference library of ``frame`` after the PA
    threshold (vip_tpu derotation.py:460)."""
    n = angle_list.shape[0]
    dpa = np.abs(angle_list - angle_list[frame])
    below = dpa[:frame] < thr
    index_prev = int(np.argmax(below)) if below.any() else frame
    above = dpa[frame:] > thr
    index_foll = frame + int(np.argmax(above)) if above.any() else n

    if out_closest:
        return index_prev, index_foll - 1

    if nframes is not None:
        window = nframes // 2
        ind1 = max(index_prev - window, 0)
        ind4 = min(index_foll + window, n)
        return np.concatenate([np.arange(ind1, index_prev),
                               np.arange(index_foll, ind4)]).astype("int32")
    indices = np.concatenate([np.arange(0, index_prev),
                              np.arange(index_foll, n)]).astype("int32")
    if truncate:
        thr_n = min(n - 1, max_frames)
        if len(indices) > thr_n:
            all_indices = indices.astype(np.int64)
            dPA = np.abs(angle_list[all_indices] - angle_list[frame])
            indices = np.sort(all_indices[np.argsort(dPA)][:thr_n])
    return indices


def _compute_pa_thresh(ann_center, fwhm, delta_rot=1):
    """PA threshold [deg] for one annulus (vip_tpu derotation.py:501)."""
    return np.rad2deg(2 * np.arctan(delta_rot * fwhm / (2 * ann_center)))


def _define_annuli(angle_list, ann, n_annuli, fwhm, radius_int, annulus_width,
                   delta_rot, n_segments, verbose, strict=False):
    """Annulus geometry (pa_threshold, inner_radius, ann_center), with the
    last annulus widened by one pixel inwards and the PA threshold capped
    at 90% of half the rotation range unless ``strict`` (vip_tpu
    derotation.py:506-533)."""
    if ann == n_annuli - 1:
        inner_radius = radius_int + (ann * annulus_width - 1)
    else:
        inner_radius = radius_int + ann * annulus_width
    ann_center = inner_radius + (annulus_width / 2)
    pa_threshold = _compute_pa_thresh(ann_center, fwhm, delta_rot)
    mid_range = np.abs(np.amax(angle_list) - np.amin(angle_list)) / 2
    if pa_threshold >= mid_range - mid_range * 0.1:
        new_pa_th = float(mid_range - mid_range * 0.1)
        if not strict:
            print("PA threshold {:.2f} is likely too big, will be set to "
                  "{:.2f}".format(pa_threshold, new_pa_th))
            pa_threshold = new_pa_th
    if verbose:
        if pa_threshold > 0:
            print("Ann {}    PA thresh: {:5.2f}    Ann center: {:3.0f}    "
                  "N segments: {} ".format(ann + 1, pa_threshold, ann_center,
                                           n_segments))
        else:
            print("Ann {}    Ann center: {:3.0f}    N segments: {} ".format(
                ann + 1, ann_center, n_segments))
    return pa_threshold, inner_radius, ann_center


def _vip_tensor(x):
    """``x`` as a float or complex tensor: a float or complex tensor as it
    is; any other on the default device (a tensor on its own), in
    float32/complex64 on CUDA and float64/complex128 on the CPU."""
    if isinstance(x, torch.Tensor) and (x.is_floating_point()
                                        or x.is_complex()):
        return x
    dev = x.device if isinstance(x, torch.Tensor) else get_device()
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    wide = dev.type != "cuda"
    if x.is_complex():
        dtype = torch.complex128 if wide else torch.complex64
    else:
        dtype = torch.float64 if wide else torch.float32
    return x.to(device=dev, dtype=dtype)


def tensor_fft_shear(arr, arr_ori, c, ax):
    """One FFT shear pass of VIP's torch three-shear rotation (vip_tpu
    derotation.py:536; VIP derotation.py:709-724): the fftshift-sandwiched
    DFT of the (1, y, x) ``arr`` (real or complex) along ``ax`` (1 or 2),
    times exp(-2πi·c·u·arr_ori), ``u`` the centered frequencies along the
    other axis and ``arr_ori`` the centered coordinate ramp. Runs on the
    device of ``arr`` (numpy input goes to the default one); the phase is
    evaluated in float64 and cast to the working complex dtype. Returns
    the complex (1, y, x) tensor."""
    arr = _vip_tensor(arr)
    dev = arr.device
    wide = arr.dtype in (torch.float64, torch.complex128)
    cdtype = torch.complex128 if wide else torch.complex64
    arr_ori = torch.as_tensor(arr_ori, dtype=torch.float64, device=dev)
    ax2 = 1 - (ax - 1) % 2
    freqs = torch.fft.fftfreq(arr_ori.shape[ax2], dtype=torch.float64,
                              device=dev)
    arr_u = torch.fft.fftshift(freqs).tile((arr_ori.shape[ax - 1], 1))
    if ax == 2:
        arr_u = arr_u.T
    theta = (-2 * math.pi * c) * arr_u * arr_ori
    phase = torch.polar(torch.ones_like(theta), theta).to(cdtype)
    s_x = torch.fft.fftshift(arr)
    s_x = torch.fft.fft(s_x, dim=ax)
    s_x = torch.fft.fftshift(s_x)
    s_x = phase * s_x
    s_x = torch.fft.fftshift(s_x)
    s_x = torch.fft.ifft(s_x, dim=ax)
    return torch.fft.fftshift(s_x)


def tensor_rotate_fft(tensor, angle):
    """Rotate a (1, y, x) frame (or a 2-d one) by ``angle`` degrees with
    VIP's torch three-shear FFT rotation (vip_tpu derotation.py:561; VIP
    derotation.py:643-706): ``angle % 360`` split into a ``rot90`` and a
    residual within ±45°; odd frames cropped to even for the shears, the
    centre that of the original shape, and padded back with a zero last
    row and column; the real part out, (1, y, x). Runs on the tensor's
    device in its float dtype (numpy input: the default device, float32
    on CUDA, float64 on the CPU). For batches of frames, each with its
    angle, the port has ``ops.fft.rotate_fft_fast_batch``."""
    tensor = _vip_tensor(tensor)
    if tensor.is_complex():
        tensor = tensor.real
    if tensor.ndim == 2:
        tensor = tensor[None]
    y_ori, x_ori = tensor.shape[1:]

    angle = float(angle) % 360.0
    if angle > 45:
        dangle = angle % 90
        if dangle > 45:
            dangle = -(90 - dangle)
        nangle = int(np.rint(angle / 90))
        tensor_in = torch.rot90(tensor, nangle, dims=(1, 2))
    else:
        dangle = angle
        tensor_in = tensor

    odd = bool(y_ori % 2 or x_ori % 2)
    if odd:
        # the shears' centre sits at (cy + 0.5, cx + 0.5): crop to even
        tensor_in = tensor_in[:, :-1, :-1]

    a = np.tan(np.deg2rad(dangle) / 2)
    b = -np.sin(np.deg2rad(dangle))

    y_new, x_new = tensor_in.shape[1:]
    yy, xx = np.mgrid[0:y_new, 0:x_new]
    cy, cx = frame_center((y_ori, x_ori))
    arr_y = yy - cy
    arr_x = xx - cx

    s_x = tensor_fft_shear(tensor_in, arr_x, a, ax=2)
    s_xy = tensor_fft_shear(s_x, arr_y, b, ax=1)
    s_xyx = tensor_fft_shear(s_xy, arr_x, a, ax=2).real
    if odd:
        out = torch.zeros((1, y_new + 1, x_new + 1), dtype=s_xyx.dtype,
                          device=s_xyx.device)
        out[0, :-1, :-1] = s_xyx[0]
        return out
    return s_xyx.contiguous()

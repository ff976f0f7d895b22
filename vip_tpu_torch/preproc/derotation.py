"""Frame and cube derotation (port of the 'vip-fft' part of
``vip_tpu.preproc.derotation``).

VIP's exact rotation: the frame sits in a ~1.5x parity-preserving canvas
inside a ~4x zero canvas, rotates by three FFT shears and is cropped back
(vip_hci/preproc/derotation.py:129-217). Every exact rotation here goes
through :func:`vip_tpu_torch.ops.shear.rotate_exact` (CUDA kernel H2 where
its gate holds). The PA-threshold library selection helpers are host-side
numpy, as in vip_tpu.

The 'skimage' imlib with bilinear interpolation and a constant border
(what VIP's greedy algorithms use to rotate their signal masks) is
OpenCV's float64 ``warpAffine``, as vip_tpu calls it, computed on the
tensor's device (:func:`_warp_bilinear`); its other interpolations and
the 'opencv' imlib wait for ROADMAP Queue 1, slice 8.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..ops.fft import rotate_fft, rotate_fft_exact_pruned
from ..ops.shear import rotate_exact
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
                 edge_blend=None, interp_zeros=False, ker=1):
    """Rotate a 2-d frame by ``angle`` degrees counter-clockwise (vip_tpu
    derotation.py:172). Only 'vip-fft' without ``edge_blend`` is ported:
    masked values (non-finite, or ``mask_val``) rotate as zeros and are
    reset afterwards."""
    array = as_tensor(array)
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array")
    if _interp_supported(imlib, interpolation, border_mode, cxy):
        return _warp_bilinear(array[None], [float(angle)])[0]
    if imlib != "vip-fft" or edge_blend:
        raise NotImplementedError(
            "frame_rotate: only imlib='vip-fft' without edge_blend is "
            "ported (ROADMAP Queue 1, slice 8)")
    if cxy is not None and tuple(cxy)[::-1] != frame_center(array):
        raise ValueError("'vip-fft' imlib does not allow custom centers")
    mask = _mask_of(array, mask_val)
    work = torch.nan_to_num(array)
    angles = torch.tensor([float(angle)], dtype=torch.float64)
    out = rotate_exact(work[None], angles)[0]
    return out.masked_fill(mask, mask_val)


# frames a chunk of the bilinear warp: its int64 source coordinates take
# about 40 bytes a pixel
_WARP_CHUNK_BYTES = 1 << 30


def _warp_bilinear(cube, angles):
    """Each frame of a (n, y, x) tensor rotated by its angle (degrees,
    counter-clockwise) about the frame center, as OpenCV's
    ``warpAffine(frame, getRotationMatrix2D((cx, cy), angle, 1), (x, y),
    INTER_LINEAR, BORDER_CONSTANT)`` computes it: the inverse map in
    fixed point (1/1024 rounded to nearest even, then 1/32 steps), the
    four taps weighted by the 1/32 fractions, zeros outside."""
    n, y, x = cube.shape
    cy, cx = frame_center((y, x))
    t = np.deg2rad(np.asarray(angles, dtype=np.float64))
    alpha, beta = np.cos(t), np.sin(t)
    m02 = (1 - alpha) * cx - beta * cy
    m12 = beta * cx + (1 - alpha) * cy
    # cv2.invertAffineTransform of [[a, b, m02], [-b, a, m12]]
    d = alpha * alpha + beta * beta
    d = np.where(d != 0, 1.0 / d, 0.0)
    a11, a12, a21, a22 = alpha * d, -beta * d, beta * d, alpha * d
    b1 = -a11 * m02 - a12 * m12
    b2 = -a21 * m02 - a22 * m12
    scale, half = 1024, 1024 // 32 // 2
    xs, ys = np.arange(x), np.arange(y)
    adelta = np.rint(a11[:, None] * xs * scale).astype(np.int64)
    bdelta = np.rint(a21[:, None] * xs * scale).astype(np.int64)
    x0 = np.rint((a12[:, None] * ys + b1[:, None]) * scale).astype(
        np.int64) + half
    y0 = np.rint((a22[:, None] * ys + b2[:, None]) * scale).astype(
        np.int64) + half
    dev = cube.device
    out = torch.empty_like(cube)
    step = int(max(1, _WARP_CHUNK_BYTES // (40 * y * x)))
    for s in range(0, n, step):
        sl = slice(s, min(n, s + step))
        X = (torch.as_tensor(x0[sl], device=dev)[:, :, None]
             + torch.as_tensor(adelta[sl], device=dev)[:, None, :]) >> 5
        Y = (torch.as_tensor(y0[sl], device=dev)[:, :, None]
             + torch.as_tensor(bdelta[sl], device=dev)[:, None, :]) >> 5
        fx = (X & 31).to(cube.dtype) / 32
        fy = (Y & 31).to(cube.dtype) / 32
        ix, iy = X >> 5, Y >> 5
        flat = cube[sl].reshape(ix.shape[0], -1)

        def tap(yy, xx):
            ok = (yy >= 0) & (yy < y) & (xx >= 0) & (xx < x)
            idx = (yy.clamp(0, y - 1) * x + xx.clamp(0, x - 1)).reshape(
                ix.shape[0], -1)
            v = flat.gather(1, idx).reshape(ix.shape)
            return torch.where(ok, v, 0.0)

        out[sl] = ((1 - fy) * (1 - fx) * tap(iy, ix)
                   + (1 - fy) * fx * tap(iy, ix + 1)
                   + fy * (1 - fx) * tap(iy + 1, ix)
                   + fy * fx * tap(iy + 1, ix + 1))
    return out


def _interp_supported(imlib, interpolation, border_mode, cxy):
    if imlib != "skimage":
        return False
    if interpolation != "bilinear" or border_mode != "constant" \
            or cxy is not None:
        raise NotImplementedError(
            "imlib 'skimage': only bilinear interpolation with a constant "
            "border about the frame center is ported (ROADMAP Queue 1, "
            "slice 8)")
    return True


def _mask_of(array, mask_val):
    if np.isnan(mask_val):
        return ~torch.isfinite(array)
    return array == mask_val


def cube_derotate(array, angle_list, imlib="vip-fft",
                  interpolation="lanczos4", cxy=None, nproc=1,
                  border_mode="constant", mask_val=np.nan, edge_blend=None,
                  interp_zeros=False, ker=1, chunk="auto"):
    """Derotate an ADI cube: frame i is rotated by ``-angle_list[i]``
    (vip_tpu derotation.py:344-422).

    'vip-fft' runs the exact rotation on the cube's device in chunks of
    ``chunk`` frames ('auto': :func:`_auto_chunk`); masked values
    (non-finite, or ``mask_val``) rotate as zeros and are reset afterwards.
    'vip-fft-small' is the packed speed mode on a 1.25x canvas restricted
    to the inscribed circle (odd or non-square frames take 'vip-fft').
    ``nproc`` is accepted for API parity and ignored. Returns a tensor.
    """
    from ..ops.pipeline import _derotate_frames

    array = as_tensor(array)
    n = array.shape[0]
    angles = as_tensor(angle_list, array.device, array.dtype)
    if angles.ndim == 0:
        angles = angles.expand(n)
    if angles.shape[0] != n:
        raise ValueError("angle_list length must match the cube")
    if edge_blend:
        raise NotImplementedError(
            "cube_derotate: edge_blend is not ported (ROADMAP Queue 1, "
            "slice 8)")
    if imlib == "vip-fft-small" and (array.shape[-1] % 2 != 0
                                     or array.shape[-2] != array.shape[-1]):
        imlib = "vip-fft"  # speed mode needs even square frames

    if imlib == "vip-fft":
        if chunk == "auto":
            chunk = _auto_chunk(n, array.shape[-1], array.element_size())
        mask = _mask_of(array, mask_val)
        has_mask = bool(mask.any())
        work = array.masked_fill(mask, 0.0) if has_mask else array
        out = _rotate_chunks(work, -angles, chunk)
        return out.masked_fill(mask, mask_val) if has_mask else out
    elif imlib == "vip-fft-small":
        if chunk == "auto":
            chunk = min(n, max(1, 4 * _auto_chunk(n, array.shape[-1],
                                                  array.element_size())))
        work = torch.nan_to_num(array)
        return _derotate_frames(work, angles, chunk=chunk,
                                rot_mode="fft-small")
    elif _interp_supported(imlib, interpolation, border_mode, cxy):
        host = angle_list.detach().cpu().numpy() \
            if isinstance(angle_list, torch.Tensor) else angle_list
        host = np.broadcast_to(np.asarray(host, np.float64), (n,))
        return _warp_bilinear(array, -host)
    raise NotImplementedError(
        f"cube_derotate: imlib {imlib!r} is not ported (only 'vip-fft', "
        "'vip-fft-small', and 'skimage' bilinear; the other interpolation "
        "rotations wait for ROADMAP Queue 1, slice 8)")


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

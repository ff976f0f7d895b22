"""Sigma filtering and clipping of bad pixels (port of
``vip_tpu.stats.clip_sigma``).

Both run on the frame's device through ``ops.badpix``: the iterative
bad-pixel replacement (each sweep gathers the 3x3 windows of the bad
pixels left) and the neighbour sigma clip (one masked-window pass).
Frames smaller than the window take vip_tpu's host routes
(``_sigma_filter_host``, ``_clip_neighbor_host``).
"""

import numpy as np
import torch

from ..config.device import as_tensor

__all__ = ["clip_array", "sigma_filter"]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def sigma_filter(frame_tmp, bpix_map, neighbor_box=3, min_neighbors=3,
                 half_res_y=False, verbose=False, no_numba=False):
    """Replace the bad pixels of a frame by the median of their good
    neighbours, sweep after sweep (vip_tpu clip_sigma.py:17).

    As vip_tpu (and VIP, whose inner routine is always called so), the
    window is 3x3 and 3 good neighbours are needed, whatever
    ``neighbor_box`` and ``min_neighbors`` say. A writeable numpy frame is
    corrected in place and returned; a tensor gives a new tensor on its
    device. Numpy input runs on :func:`~vip_tpu_torch.get_device`."""
    if frame_tmp.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array")
    if min(frame_tmp.shape) < 3:
        out = _sigma_filter_host(np.array(_host(frame_tmp)), _host(bpix_map),
                                 verbose=verbose)
    else:
        from ..ops.badpix import sigma_filter_device

        out, nit = sigma_filter_device(frame_tmp, bpix_map, min_neighbors=3)
        if verbose:
            print("Required number of iterations in the sigma filter: ",
                  int(nit))
    if isinstance(frame_tmp, torch.Tensor):
        return torch.as_tensor(out, device=frame_tmp.device)
    out = _host(out).astype(frame_tmp.dtype, copy=False)
    if isinstance(frame_tmp, np.ndarray) and frame_tmp.flags.writeable:
        np.copyto(frame_tmp, out)       # vip_tpu writes in place
        return frame_tmp
    return out


def cube_sigma_filter(cube, bpix_maps, verbose=False):
    """:func:`sigma_filter` of every frame of a cube in one batched call
    (vip_tpu clip_sigma.py:45). Returns a tensor on the cube's device."""
    from ..ops.badpix import cube_sigma_filter_device

    out, nits = cube_sigma_filter_device(cube, bpix_maps, min_neighbors=3)
    if verbose:
        print("Required number of iterations in the sigma filter: ",
              int(nits.max()))
    return out


def _sigma_filter_host(frame_tmp, bpix_map, neighbor_box=3, min_neighbors=3,
                       half_res_y=False, verbose=False):
    """vip_tpu's host sweep (clip_sigma.py:57): a numpy loop over the bad
    pixels, the window 3x3 and 3 neighbours whatever is passed, corrected
    in place in ``frame_tmp``. The route of frames smaller than the window,
    and the loop the device route is held to."""
    neighbor_box = 3
    min_neighbors = 3
    sz_y, sz_x = frame_tmp.shape
    bp = np.asarray(bpix_map).copy()
    im = frame_tmp
    nb = int(np.sum(bp))
    nit = 0
    half_box_x = int(np.floor(neighbor_box / 2.))
    half_box_y = max(1, int(half_box_x / 2)) if half_res_y else half_box_x

    while nb > 0:
        nit += 1
        wb = np.where(bp)
        gp = 1 - bp
        for n in range(nb):
            hbox_b = min(half_box_y, wb[0][n])
            hbox_t = min(half_box_y, sz_y - 1 - wb[0][n])
            hbox_l = min(half_box_x, wb[1][n])
            hbox_r = min(half_box_x, sz_x - 1 - wb[1][n])
            # the box shifts inward at the edges (VIP clip_sigma.py:93-100)
            if hbox_b < hbox_t:
                hbox_t += half_box_y - hbox_b
            elif hbox_t < hbox_b:
                hbox_b += half_box_y - hbox_t
            if hbox_l < hbox_r:
                hbox_r += half_box_x - hbox_l
            elif hbox_r < hbox_l:
                hbox_l += half_box_x - hbox_r
            sgp = gp[(wb[0][n] - hbox_b):(wb[0][n] + hbox_t + 1),
                     (wb[1][n] - hbox_l):(wb[1][n] + hbox_r + 1)]
            if int(np.sum(sgp)) >= min_neighbors:
                sim = im[(wb[0][n] - hbox_b):(wb[0][n] + hbox_t + 1),
                         (wb[1][n] - hbox_l):(wb[1][n] + hbox_r + 1)]
                im[wb[0][n], wb[1][n]] = np.median(sim[np.where(sgp)])
                bp[wb[0][n], wb[1][n]] = 0
        nb_new = int(np.sum(bp))
        if nb_new == nb:  # stalled: no pixel has enough good neighbours
            break
        nb = nb_new
    if verbose:
        print("Required number of iterations in the sigma filter: ", nit)
    return im


def _median_all(t):
    """The median of all the values of a tensor, the two middles averaged
    for an even count (numpy's; ``torch.median`` takes the lower)."""
    s = torch.sort(t.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def clip_array(array, lower_sigma, upper_sigma, bpm_mask_ori=None,
               out_good=False, neighbor=False, num_neighbor=3, mad=False,
               min_std=None, half_res_y=False, no_numba=False):
    """Sigma clipping of a frame against its global median and standard
    deviation, or with ``neighbor`` against those (or the MAD) of each
    pixel's ``num_neighbor``-wide window of good pixels (vip_tpu
    clip_sigma.py:106). The masks are computed on the frame's device
    (numpy input on :func:`~vip_tpu_torch.get_device`); returns the host
    (y, x) indices of the clipped pixels, or of the others with
    ``out_good``, as ``np.where``."""
    if array.ndim != 2:
        raise TypeError("Input array is not two dimensional (frame)\n")
    ny, nx = array.shape
    if neighbor and num_neighbor:
        gpm_ori = np.ones((ny, nx), dtype=bool) if bpm_mask_ori is None \
            else ~_host(bpm_mask_ori).astype(bool)
        half_box_x = int(np.floor(num_neighbor / 2.))
        half_box_y = max(1, int(half_box_x / 2)) if half_res_y \
            else half_box_x
        if ny < 2 * half_box_y + 1 or nx < 2 * half_box_x + 1:
            bpm = _clip_neighbor_host(_host(array), gpm_ori, lower_sigma,
                                      upper_sigma, half_box_y, half_box_x,
                                      mad, min_std)
        else:
            from ..ops.badpix import clip_neighbor_device

            bpm = _host(clip_neighbor_device(
                array, gpm_ori, float(lower_sigma), float(upper_sigma),
                half_box_y, half_box_x, mad=bool(mad),
                has_min_std=min_std is not None,
                min_std=0.0 if min_std is None else float(min_std)))
    else:
        a = as_tensor(array)
        median = _median_all(a)
        sigma = a.std(correction=0)
        if min_std is not None:
            sigma = torch.clamp(sigma, min=min_std)
        bpm = _host((a < (median - lower_sigma * sigma))
                    | (a > (median + upper_sigma * sigma)))
    return np.where(~bpm) if out_good else np.where(bpm)


def _members(n, h):
    """(n, m) host indices of the window members along an axis of n
    pixels, box half-width h: the inward-shifted window of 2h + 1, or the
    whole axis when it is shorter (vip_tpu's loop clips the box there)."""
    w = 2 * h + 1
    if n < w:
        return np.broadcast_to(np.arange(n), (n, n))
    ar = np.arange(n)
    return np.stack([np.clip(ar - h + d, d, n - w + d) for d in range(w)],
                    axis=-1)


def _clip_neighbor_host(array, gpm_ori, lower_sigma, upper_sigma,
                        half_box_y, half_box_x, mad, min_std):
    """The host route of the neighbour clip (vip_tpu clip_sigma.py:149):
    the same statistics as vip_tpu's per-pixel loop, vectorized over the
    pixels with numpy masked arrays. Each good pixel's window (shifted
    inward at the edges) loses one value equal to the pixel's own, the
    first in row order, as in the loop; a pixel with no value left is not
    clipped. Used for frames smaller than the window, and as the host
    reference of the device route."""
    a = np.asarray(array, dtype=float)
    gpm = np.asarray(gpm_ori, dtype=bool)
    ny, nx = a.shape
    iy = _members(ny, half_box_y)[:, None, :, None]
    ix = _members(nx, half_box_x)[None, :, None, :]
    vals = a[iy, ix].reshape(ny, nx, -1)
    good = gpm[iy, ix].reshape(ny, nx, -1)
    # drop the first good value equal to the pixel's own
    same = good & (vals == a[..., None])
    first = same & (np.cumsum(same, axis=-1) == 1)
    keep = good & ~first
    neigh = np.ma.masked_array(vals, mask=~keep)
    k = keep.sum(axis=-1)
    median = np.ma.median(neigh, axis=-1).filled(np.nan)
    if mad:
        sigma = np.ma.median(np.abs(median[..., None] - neigh),
                             axis=-1).filled(np.nan)
    else:
        sigma = neigh.std(axis=-1).filled(np.nan)
    if min_std is not None:
        sigma = np.maximum(sigma, min_std)
    with np.errstate(invalid="ignore"):
        bad = (a < (median - lower_sigma * sigma)) \
            | (a > (median + upper_sigma * sigma))
    return np.where(gpm, bad & (k > 0), True)

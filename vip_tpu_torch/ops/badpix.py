"""Bad-pixel window filters: the iterative sigma filter, the neighbour
sigma clip and scipy's median filter (port of ``vip_tpu.ops.badpix``;
jnp code there, not Pallas).

Window semantics (vip_tpu badpix.py:1-18): the box around a pixel keeps
its size at the edges by shifting inward, so the member at offset ``d``
of a window of width ``w`` (half ``h``) about position ``i`` is
``clip(i - h + d, d, n - w + d)``. A masked median of an even count
averages the two middles (``_masked_median``; ``torch.median`` would
return the lower one).

The sigma filter is iteration-synchronous: each sweep freezes the
good-pixel map, replaces every bad pixel that has at least
``min_neighbors`` good ones in its 3x3 window by their median, and marks
it good. A frame stops when no bad pixel is left, when a sweep fixes
none, or after ``(max(ny, nx) + 1) // 2 + 2`` sweeps; its sweep count is
returned. On every device the route gathers the windows of the bad
pixels of each sweep alone (``_sigma_filter_gathered``): at 1000x512²
vip_tpu's dense ``[.., ny, nx, 9]`` window stack is 9.4 GB in float32.
The dense form, in frame chunks under ``_DENSE_BYTES``, is its plain
version (``_sigma_filter_dense``); the two give the same bits.
"""

import numpy as np
import torch

from ..config.device import as_tensor

__all__ = ["sigma_filter_device", "cube_sigma_filter_device",
           "clip_neighbor_device", "median_filter_device", "median_filter_at"]

# The dense plain version's working set: each pixel of a chunk holds its
# window's values, sorted values, sort indices and flags (~24 bytes a
# member), under the port's 8 GiB budget (preproc/derotation.py:122)
_DENSE_BYTES = 8 << 30


def _window_index(n, h, w):
    """Host (w, n) index vectors ``clip(arange(n) - h + d, d, n - w + d)``
    of the window members at offsets d = 0..w-1 (vip_tpu badpix.py:57)."""
    ar = np.arange(n)
    return np.stack([np.clip(ar - h + d, d, n - w + d) for d in range(w)])


def _window_flat(ny, nx, hy, hx, device):
    """(ny, nx, wy·wx) flat frame indices of every pixel's window, members
    in vip_tpu's order (offset dy major, dx minor)."""
    iy = _window_index(ny, hy, 2 * hy + 1)
    ix = _window_index(nx, hx, 2 * hx + 1)
    flat = iy.T[:, None, :, None] * nx + ix.T[None, :, None, :]
    return torch.as_tensor(flat.reshape(ny, nx, -1), device=device)


def _windows(a, flat):
    """[..., ny, nx, W] window values of the frames of ``a`` (W members
    each, ``flat`` from :func:`_window_flat`)."""
    return a.reshape(*a.shape[:-2], -1)[..., flat]


def _masked_median(vals, good, k):
    """The median of ``vals[good]`` along the last axis, the two middles
    averaged for an even count ``k``; NaN where k == 0 (vip_tpu
    badpix.py:64)."""
    big = torch.finfo(vals.dtype).max
    svals = torch.sort(torch.where(good, vals, big), dim=-1).values
    last = svals.shape[-1] - 1
    ilo = torch.div(k - 1, 2, rounding_mode="floor").clamp(0, last)
    ihi = torch.div(k, 2, rounding_mode="floor").clamp(0, last)
    lo = torch.gather(svals, -1, ilo.unsqueeze(-1)).squeeze(-1)
    hi = torch.gather(svals, -1, ihi.unsqueeze(-1)).squeeze(-1)
    return torch.where(k > 0, 0.5 * (lo + hi), torch.nan)


def _float(x):
    """A float tensor of ``x``; raw integer detector frames become
    float32, as in vip_tpu."""
    if not isinstance(x, torch.Tensor) and np.asarray(x).dtype.kind != "f":
        return as_tensor(x, dtype=torch.float32)
    x = as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.float32)


def _max_sweeps(ny, nx):
    # the worst case erodes one ring of a frame-sized clump a sweep
    return (max(ny, nx) + 1) // 2 + 2


def _sigma_filter_gathered(cube, bp, min_neighbors):
    """The sigma filter of a batch (B, ny, nx) with bad-pixel map ``bp``
    (bool), gathering each sweep's bad-pixel windows only. Returns the
    filtered frames and each frame's sweep count (int32)."""
    im = cube.clone()
    bp = bp.clone()
    B, ny, nx = im.shape
    max_it = _max_sweeps(ny, nx)
    offs = torch.arange(3, device=im.device)
    flat_im, flat_bp = im.view(-1), bp.view(-1)
    nb = bp.sum(dim=(1, 2))
    nit = torch.zeros(B, dtype=torch.int32, device=im.device)
    active = nb > 0
    while bool(active.any()):
        b, y, x = torch.nonzero(bp & active[:, None, None], as_tuple=True)
        wy = (y - 1).clamp(0, ny - 3)[:, None] + offs
        wx = (x - 1).clamp(0, nx - 3)[:, None] + offs
        idx = (b[:, None, None] * (ny * nx) + wy[:, :, None] * nx
               + wx[:, None, :]).reshape(-1, 9)
        vals, good = flat_im[idx], ~flat_bp[idx]
        k = good.sum(dim=-1)
        fix = k >= min_neighbors
        at = (b * (ny * nx) + y * nx + x)[fix]
        flat_im[at] = _masked_median(vals[fix], good[fix], k[fix])
        flat_bp[at] = False
        nit += active.to(torch.int32)
        nb_new = bp.sum(dim=(1, 2))
        active = active & (nb_new > 0) & (nb_new < nb) & (nit < max_it)
        nb = nb_new
    return im, nit


def _sigma_filter_dense(cube, bp, min_neighbors):
    """The plain version of :func:`_sigma_filter_gathered`, as vip_tpu
    computes it: every sweep takes the masked median of every pixel's
    window and keeps it where a bad pixel can be fixed; frames in chunks
    whose window stacks fit ``_DENSE_BYTES``. Bit-equal to the gathered
    route."""
    B, ny, nx = cube.shape
    chunk = max(1, min(B, _DENSE_BYTES // (ny * nx * 9 * 24)))
    flat = _window_flat(ny, nx, 1, 1, cube.device)
    max_it = _max_sweeps(ny, nx)
    outs, nits = [], []
    for s in range(0, B, chunk):
        im, b = cube[s:s + chunk].clone(), bp[s:s + chunk].clone()
        nb = b.sum(dim=(1, 2))
        nit = torch.zeros(im.shape[0], dtype=torch.int32, device=im.device)
        active = nb > 0
        while bool(active.any()):
            good = _windows(~b, flat)
            k = good.sum(dim=-1)
            med = _masked_median(_windows(im, flat), good, k)
            fix = b & (k >= min_neighbors) & active[:, None, None]
            im = torch.where(fix, med, im)
            b = b & ~fix
            nit += active.to(torch.int32)
            nb_new = b.sum(dim=(1, 2))
            active = active & (nb_new > 0) & (nb_new < nb) & (nit < max_it)
            nb = nb_new
        outs.append(im)
        nits.append(nit)
    return torch.cat(outs), torch.cat(nits)


def sigma_filter_device(frame, bpix_map, min_neighbors=3):
    """Replace the bad pixels of a frame by the median of the good ones of
    their inward-shifted 3x3 window, sweep after sweep (vip_tpu
    badpix.py:80). Returns (frame, sweeps) as tensors on the frame's
    device (numpy input on :func:`~vip_tpu_torch.get_device`)."""
    out, nit = cube_sigma_filter_device(_float(frame)[None],
                                        as_tensor(bpix_map)[None],
                                        min_neighbors)
    return out[0], nit[0]


def cube_sigma_filter_device(cube, bpix_maps, min_neighbors=3):
    """:func:`sigma_filter_device` of every frame of a cube at once
    (vip_tpu badpix.py:122). Returns (cube, sweeps of each frame)."""
    cube = _float(cube)
    bp = as_tensor(bpix_maps, cube.device) != 0
    return _sigma_filter_gathered(cube, bp, int(min_neighbors))


def _pad_index(n, lo, hi, mode):
    """Host source index of the positions -lo .. n - 1 + hi along an axis
    of n pixels under scipy.ndimage's boundary ``mode``: 'mirror' (d c b |
    a b c d | c b a), 'reflect' (b a | a b c d | d c) or 'nearest' (a a |
    a b c d | d d), periodic so that any pad length works."""
    q = np.arange(-lo, n + hi)
    if mode == "nearest":
        return np.clip(q, 0, n - 1)
    if mode == "mirror":
        if n == 1:
            return np.zeros_like(q)
        q = np.mod(q, 2 * n - 2)
        return np.where(q >= n, 2 * n - 2 - q, q)
    if mode == "reflect":
        q = np.mod(q, 2 * n)
        return np.where(q >= n, 2 * n - 1 - q, q)
    raise ValueError(f"median filter mode {mode!r} not supported ('mirror',"
                     " 'reflect' or 'nearest')")


def _median_window(size):
    """(lo, hi, rank) of scipy's ``median_filter`` of ``size``: the window
    spans offsets [-lo, hi] (scipy's origin: [-s/2, s/2 - 1] for an even
    size) and the median is the value of 0-based rank size² // 2."""
    lo = size // 2
    return lo, size - 1 - lo, (size * size) // 2


def _quickselect(buf, rank):
    """scipy.ndimage's ``NI_Select`` (ni_filters.c: Hoare partitions about
    the first value, recursing into the side that holds ``rank``) of every
    row of a (K, W) tensor, all rows stepped together, one pointer move a
    row a step. On NaN-free rows it is the rank-th smallest value, as a
    sort gives; a row with a NaN gets the value scipy's median filter
    gives it (the comparisons with NaN are false)."""
    buf = buf.clone()
    K, W = buf.shape
    dev = buf.device
    rows = torch.arange(K, device=dev)
    lo = torch.zeros(K, dtype=torch.long, device=dev)
    hi = torch.full((K,), W - 1, dtype=torch.long, device=dev)
    rk = torch.full((K,), int(rank), dtype=torch.long, device=dev)
    ii, jj = lo - 1, hi + 1
    x = buf[:, 0].clone()
    # phase 1 steps jj down past values > x, phase 2 steps ii up past
    # values < x, phase 3 swaps or picks the side that holds the rank
    phase = torch.ones(K, dtype=torch.long, device=dev)
    done = lo == hi
    while not bool(done.all()):
        p1 = ~done & (phase == 1)
        p2 = ~done & (phase == 2)
        p3 = ~done & (phase == 3)
        jj = torch.where(p1, jj - 1, jj)
        ii = torch.where(p2, ii + 1, ii)
        vj = buf[rows, jj.clamp(0, W - 1)]
        vi = buf[rows, ii.clamp(0, W - 1)]
        phase = torch.where(p1 & ~(vj > x), 2, phase)
        phase = torch.where(p2 & ~(vi < x), 3, phase)
        swap = p3 & (ii < jj)
        if bool(swap.any()):
            r, a, b = rows[swap], ii[swap], jj[swap]
            va, vb = buf[r, a].clone(), buf[r, b].clone()
            buf[r, a], buf[r, b] = vb, va
        phase = torch.where(swap, 1, phase)
        split = p3 & ~swap
        k = jj - lo + 1
        left = split & (rk < k)
        right = split & ~(rk < k)
        hi = torch.where(left, jj, hi)
        rk = torch.where(right, rk - k, rk)
        lo = torch.where(right, jj + 1, lo)
        done = done | (split & (lo == hi))
        restart = split & (lo != hi)
        x = torch.where(restart, buf[rows, lo], x)
        ii = torch.where(restart, lo - 1, ii)
        jj = torch.where(restart, hi + 1, jj)
        phase = torch.where(restart, 1, phase)
    return buf[rows, lo]


def _window_median(win, rank):
    """The value of rank ``rank`` of each row of (..., W) windows as
    scipy's median filter gives it: a sort's for rows without NaN, scipy's
    own selection (:func:`_quickselect`) for the rows with one."""
    out = torch.sort(win, dim=-1).values[..., rank]
    nan = torch.isnan(win).any(dim=-1)
    if bool(nan.any()):
        out[nan] = _quickselect(win[nan], rank)
    return out


def median_filter_device(frames, size, mode="mirror"):
    """``scipy.ndimage.median_filter(x, size, mode=mode)`` of the frames
    of a tensor (any leading axes; vip_tpu badpix.py:132) for the modes
    'mirror', 'reflect' and 'nearest', odd and even sizes, frames smaller
    than the window included, NaNs as scipy's selection meets them: the
    value of rank size² // 2 of each pixel's size² window (scipy's upper
    middle for an even size), frames in chunks whose window stacks fit
    ``_DENSE_BYTES``."""
    frames = as_tensor(frames)
    size = int(size)
    ny, nx = frames.shape[-2:]
    lo, hi, rank = _median_window(size)
    iy = torch.as_tensor(_pad_index(ny, lo, hi, mode), device=frames.device)
    ix = torch.as_tensor(_pad_index(nx, lo, hi, mode), device=frames.device)
    flat = frames.reshape(-1, ny, nx)
    # each window member holds its value, the sorted value and its index
    per_frame = ny * nx * size * size * (2 * flat.element_size() + 8)
    chunk = max(1, min(flat.shape[0], _DENSE_BYTES // per_frame))
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], chunk):
        p = flat[s:s + chunk][:, iy[:, None], ix[None, :]]
        win = p.unfold(1, size, 1).unfold(2, size, 1)
        out[s:s + chunk] = _window_median(win.reshape(*win.shape[:3], -1),
                                          rank)
    return out.reshape(frames.shape)


def median_filter_at(frames, b, y, x, size, mode="mirror"):
    """The values of :func:`median_filter_device` of a (B, ny, nx) tensor
    at the pixels (b, y, x) alone (index tensors on its device): their
    windows gathered, as scipy's ``median_filter`` would give them there.
    Bit-equal to the whole filter at those pixels."""
    ny, nx = frames.shape[-2:]
    lo, hi, rank = _median_window(int(size))
    dev = frames.device
    py = torch.as_tensor(_pad_index(ny, lo, hi, mode), device=dev)
    px = torch.as_tensor(_pad_index(nx, lo, hi, mode), device=dev)
    offs = torch.arange(int(size), device=dev)
    wy = py[y[:, None] + offs]                      # (k, s) source rows
    wx = px[x[:, None] + offs]
    idx = (b[:, None, None] * (ny * nx) + wy[:, :, None] * nx
           + wx[:, None, :]).reshape(b.shape[0], -1)
    return _window_median(frames.reshape(-1)[idx], rank)


def clip_neighbor_device(array, gpm_ori, lower_sigma, upper_sigma, hy, hx,
                         mad=False, has_min_std=False, min_std=0.0):
    """The neighbour branch of ``clip_array`` (vip_tpu badpix.py:157): each
    originally good pixel against the median ± sigma (the standard
    deviation, or the MAD with ``mad``, at least ``min_std`` with
    ``has_min_std``) of the good pixels of its inward-shifted (2hy+1,
    2hx+1) window without itself. ``array`` is a frame or a batch with
    leading frame axes (``gpm_ori`` the frame's map or one a frame); the
    frames run in chunks whose window stacks fit ``_DENSE_BYTES``, each
    bit-equal to its own call. Returns the bad-pixel map (bool tensor), the
    originally bad pixels True."""
    a = _float(array)
    gpm = as_tensor(gpm_ori, a.device) != 0
    ny, nx = a.shape[-2:]
    flat = _window_flat(ny, nx, hy, hx, a.device)
    center = flat == torch.arange(ny * nx, device=a.device).reshape(
        ny, nx, 1)
    frames = a.reshape(-1, ny, nx)
    gpms = gpm.reshape(-1, ny, nx).expand(frames.shape[0], -1, -1)
    # a member's value, flag, sorted value and index, and the MAD's pass
    per_frame = ny * nx * flat.shape[-1] * (4 * a.element_size() + 17)
    chunk = max(1, min(frames.shape[0], _DENSE_BYTES // per_frame))
    out = torch.empty(frames.shape, dtype=torch.bool, device=a.device)
    for s in range(0, frames.shape[0], chunk):
        out[s:s + chunk] = _clip_neighbor(
            frames[s:s + chunk], gpms[s:s + chunk], flat, center,
            lower_sigma, upper_sigma, mad, has_min_std, min_std)
    return out.reshape(a.shape)


def _clip_neighbor(a, gpm, flat, center, lower_sigma, upper_sigma, mad,
                   has_min_std, min_std):
    """:func:`clip_neighbor_device` of a (B, ny, nx) chunk."""
    wim = _windows(a, flat)
    good = _windows(gpm, flat) & ~center
    k = good.sum(dim=-1)
    med = _masked_median(wim, good, k)
    if mad:
        sigma = _masked_median(torch.abs(med[..., None] - wim), good, k)
    else:
        gf = good.to(a.dtype)
        kf = k.clamp(min=1).to(a.dtype)
        mean = (wim * gf).sum(dim=-1) / kf
        var = ((wim - mean[..., None]) ** 2 * gf).sum(dim=-1) / kf
        sigma = torch.where(k > 0, torch.sqrt(var), torch.nan)
    if has_min_std:
        sigma = torch.clamp(sigma, min=min_std)
    bad = (a < (med - lower_sigma * sigma)) | (a > (med + upper_sigma * sigma))
    return torch.where(gpm, bad, True)

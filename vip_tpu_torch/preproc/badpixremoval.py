"""Bad-pixel identification and correction (port of
``vip_tpu.preproc.badpixremoval``).

vip_tpu loops over frames on the host for most of these routines. Here
each runs a batch of frames on its device:

- the isolated correction detects with the batched neighbour clip
  (``ops.badpix.clip_neighbor_device`` with leading frame axes) and
  replaces each bad pixel by the median of its window, gathered at the
  bad pixels alone (``ops.badpix.median_filter_at``, scipy's mirror
  median filter there);
- the clump correction runs its detect, sigma-filter, re-detect loop on
  all frames at once, each frame frozen once it has no bad pixel left, so
  that each keeps vip_tpu's iteration count;
- the annulus correction takes every (frame, annulus) trimmed median and
  standard deviation from one segmented sort on the device, with the
  numba quirks of ``reject_outliers`` and ``_trimmed_med_std`` kept, and
  numpy's global generator drawing each frame's replacement noise on the
  host in frame order, as vip_tpu does;
- the [AAC01] FFT interpolation runs all frames' iterations together:
  each frame's strongest half-spectrum component by one argmax, the
  error-spectrum update as per-frame gathers of the rolled window
  spectrum, each frame frozen once ``Eg < tol`` (the end tested every few
  iterations), so that each keeps its iteration count and snapshots;
- the IFS correction rescales the z·(z − 1) flux-matched channel pairs
  by their exact FFT-zoom operators in batched matrix products, and takes
  every channel's residual median in one launch of CUDA kernel H1 with
  ``propagate=True`` (numpy's median: any NaN gives NaN, an even count
  averages the two middles) on the card.

Frames and cubes come back as tensors on their device; bad-pixel maps
too. The plain version of each batched route is its per-frame loop of
the same functions (the frame entry points), held to it in the tests.
"""

import numpy as np
import torch

from ..config import time_ini, timing
from ..config.device import as_tensor
from ..stats.clip_sigma import _host
from ..ops.badpix import (clip_neighbor_device, cube_sigma_filter_device,
                          median_filter_at, median_filter_device)
from ..var.coords import frame_center
from ..var.shapes import get_annulus_segments

__all__ = ["frame_fix_badpix_isolated", "cube_fix_badpix_isolated",
           "cube_fix_badpix_annuli", "cube_fix_badpix_clump",
           "cube_fix_badpix_ifs", "cube_fix_badpix_interp",
           "frame_fix_badpix_fft"]


def median_filter(frame, size, mode="mirror"):
    """``scipy.ndimage.median_filter(frame, size, mode=mode)`` of a frame
    (or of the frames of a tensor) on its device (vip_tpu
    badpixremoval.py:22): 'mirror', 'reflect' or 'nearest', frames smaller
    than the window included (no host route). Returns a tensor."""
    return median_filter_device(as_tensor(frame), int(size), mode=mode)


def _cube_median_filter(cube, size, chunk=100):
    """The mirror median filter of every frame of a cube (vip_tpu
    badpixremoval.py:34), in chunks of frames under the device's working
    budget (``chunk`` is vip_tpu's and unused)."""
    return median_filter_device(as_tensor(cube), int(size), mode="mirror")


# ---------------------------------------------------------------------------
# shared host-side helpers (vip_tpu badpixremoval.py:54-150)
# ---------------------------------------------------------------------------
def _disk_mask(cy, cx, radius, shape):
    """Boolean mask of the strict-interior disk (skimage.draw.disk)."""
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    return (yy - cy) ** 2 + (xx - cx) ** 2 < radius ** 2


def _ellipse_mask(cy, cx, ry, rx, shape):
    """Boolean mask of the strict-interior ellipse (skimage.draw.ellipse)."""
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1


def _protect_region(cy, cx, radius, shape, half_res_y=False):
    """Protected central zone: a disk, or a half-height ellipse when the
    frame is y-subsampled (half_res_y)."""
    if not radius:
        return np.zeros(shape, dtype=bool)
    if half_res_y:
        return _ellipse_mask(cy, cx, radius / 2.0, radius, shape)
    return _disk_mask(cy, cx, radius, shape)


def _sigma_clipped_std(data, sigma=2.5, maxiters=5):
    """Stddev of sigma-clipped data (astropy sigma_clipped_stats
    equivalent, clipping about the median; host numpy, the plain version
    of ``_clipped_std_batch``)."""
    d = np.asarray(_host(data), dtype=float).ravel()
    d = d[np.isfinite(d)]
    for _ in range(maxiters):
        med = np.median(d)
        std = np.std(d)
        keep = np.abs(d - med) <= sigma * std
        if keep.all():
            break
        d = d[keep]
    return np.std(d)


def _norm_mask(mask, shape2d, name="mask"):
    """None -> all-False; else a host bool copy, trailing dims checked."""
    if mask is None:
        return np.zeros(shape2d, dtype=bool)
    if tuple(mask.shape[-2:]) != tuple(shape2d[-2:]):
        raise AssertionError(
            f"Input {name} should match the frame shape")
    return _host(mask).astype(bool)


def _stack_per_frame(mask, nz):
    """Broadcast a 2-d mask to (nz, y, x); pass 3-d through."""
    mask = _host(mask)
    if mask.ndim == 2:
        return np.repeat(mask[None], nz, axis=0)
    return mask


def _seq_per_frame(val, nz):
    """Scalars become an nz-long list; sequences pass through."""
    return [val] * nz if np.isscalar(val) else val


def _require_odd_kernel(size):
    if size is not None and size % 2 == 0:
        raise TypeError("Size of the median blur kernel must be an odd "
                        "integer")


def _require_map_for_correct_only(correct_only, bpm_mask):
    if correct_only and bpm_mask is None:
        raise ValueError("Bad pixel map should be provided if correct_only "
                         "is True.")


def _seed_from_values(array, bad_values, bpm_mask):
    """Flag every pixel equal to one of ``bad_values`` in the map (host
    bool)."""
    if bad_values is None:
        return bpm_mask
    arr = _host(array)
    # vip_tpu ORs a frame's map with a cube's matches, which fails to
    # broadcast (ROADMAP Queue 3): the map goes to every frame
    seeded = np.zeros(arr.shape, dtype=bool) if bpm_mask is None \
        else np.broadcast_to(_host(bpm_mask).astype(bool), arr.shape).copy()
    for bad in bad_values:
        seeded |= arr == bad
    return seeded


def _clump_kernel_geom(fwhm):
    """Odd neighbor-box edge from the FWHM + minimum neighbor count
    (the reference's sum over the odd box perimeter sizes)."""
    edge = int(round(fwhm))
    edge += 1 - edge % 2
    box = max(3, edge)
    return box, int(np.arange(3, box + 2, 2).sum())


def _dev_bool(mask, device):
    return torch.as_tensor(np.asarray(mask, dtype=bool), device=device)


def _float(array):
    array = as_tensor(array)
    return array if array.is_floating_point() else array.to(torch.float64)


# ---------------------------------------------------------------------------
# batched detection
# ---------------------------------------------------------------------------
def _median_numpy(v):
    """numpy's median of each row of a (B, P) tensor."""
    s = torch.sort(v, dim=-1).values
    P = s.shape[-1]
    return 0.5 * (s[:, (P - 1) // 2] + s[:, P // 2])


def _clip_frames(frames, seeds, sigma, num_neig, mad, half_res_y=False):
    """``clip_array(frame, sigma, sigma, seed, neighbor=num_neig > 0,
    num_neighbor=num_neig, mad=mad, half_res_y=...)`` of every frame of a
    (B, ny, nx) batch as a bool map (vip_tpu clip_sigma.py:106): the
    neighbour clip in one batched call, the global clip against each
    frame's median and standard deviation."""
    from ..stats.clip_sigma import clip_array

    B, ny, nx = frames.shape
    if num_neig:
        hx = int(np.floor(num_neig / 2.))
        hy = max(1, int(hx / 2)) if half_res_y else hx
        if ny >= 2 * hy + 1 and nx >= 2 * hx + 1:
            return clip_neighbor_device(frames, ~seeds, float(sigma),
                                        float(sigma), hy, hx, mad=bool(mad))
        out = torch.zeros((B, ny, nx), dtype=torch.bool,
                          device=frames.device)
        for b in range(B):
            hits = clip_array(frames[b], sigma, sigma, _host(seeds[b]),
                              neighbor=True, num_neighbor=num_neig, mad=mad,
                              half_res_y=half_res_y)
            out[b][torch.as_tensor(hits[0]), torch.as_tensor(hits[1])] = True
        return out
    flat = frames.reshape(B, -1)
    med = _median_numpy(flat)[:, None, None]
    std = flat.std(dim=-1, correction=0)[:, None, None]
    return (frames < med - sigma * std) | (frames > med + sigma * std)


def _protect_stack(cys, cxs, radius, shape, half_res_y, device):
    """(B, ny, nx) bool stack of the protected zones about each frame's
    (cy, cx)."""
    cache = {}
    rows = []
    for cy, cx in zip(cys, cxs):
        key = (cy, cx)
        if key not in cache:
            cache[key] = _protect_region(cy, cx, radius, shape, half_res_y)
        rows.append(cache[key])
    return _dev_bool(np.stack(rows), device)


def _replace_by_median(frames, bpm, size):
    """The frames with every pixel of the (B, ny, nx) map replaced by the
    mirror median of its ``size``² window (scipy's median filter there),
    the windows of the bad pixels alone gathered."""
    fixed = frames.clone()
    b, y, x = torch.nonzero(bpm, as_tuple=True)
    if b.numel():
        fixed[b, y, x] = median_filter_at(frames, b, y, x, size, "mirror")
    return fixed


# ---------------------------------------------------------------------------
# isolated bad pixels (sigma clip + local median)
# ---------------------------------------------------------------------------
def _isolated_frames(frames, bpm, correct_only, sigma_clip, num_neig, size,
                     protect_mask, cys, cxs, mad, ignore_nan, excl):
    """:func:`frame_fix_badpix_isolated` of every frame of a (B, ny, nx)
    batch: ``bpm`` and ``excl`` are (B, ny, nx) bool tensors (``bpm`` may
    be None), ``cys``/``cxs`` each frame's center. Returns the corrected
    frames and the maps."""
    detect = bpm is None or not correct_only
    if detect:
        seed = excl if bpm is None else (bpm | excl)
        bpm = _clip_frames(frames, seed, sigma_clip, num_neig, mad)
        if ignore_nan:
            bpm &= ~torch.isnan(frames)
        bpm &= ~_protect_stack(cys, cxs, protect_mask,
                               tuple(frames.shape[-2:]), False,
                               frames.device)
        bpm &= ~excl
    return _replace_by_median(frames, bpm, size), bpm


def frame_fix_badpix_isolated(array, bpm_mask=None, correct_only=False,
                              sigma_clip=3, num_neig=5, size=5,
                              protect_mask=0, cxy=None, mad=False,
                              ignore_nan=True, verbose=True,
                              full_output=False, excl_mask=None):
    """Sigma-clip the isolated bad pixels of a frame and replace them with
    the median of their ``size``² window (vip_tpu badpixremoval.py:152).
    Returns the frame (a tensor), and with ``full_output`` the bad-pixel
    map (a bool tensor)."""
    if array.ndim != 2:
        raise TypeError("Array is not a 2d array or single frame")
    _require_odd_kernel(size)
    _require_map_for_correct_only(correct_only, bpm_mask)
    if bpm_mask is not None:
        bpm_mask = _norm_mask(bpm_mask, array.shape, "bad pixel mask")
    if excl_mask is not None and tuple(excl_mask.shape) != \
            tuple(array.shape):
        raise AssertionError(
            "Input exclusion mask should have same shape as array\n")
    frame = _float(array)
    excl = np.zeros(frame.shape, bool) if excl_mask is None \
        else _host(excl_mask).astype(bool)

    clock = time_ini() if verbose else None
    cy, cx = frame_center(frame) if cxy is None else cxy[::-1]
    fixed, bpm = _isolated_frames(
        frame[None], None if bpm_mask is None
        else _dev_bool(bpm_mask, frame.device)[None], correct_only,
        sigma_clip, num_neig, size, protect_mask, [cy], [cx], mad,
        ignore_nan, _dev_bool(excl, frame.device)[None])
    if verbose:
        print(f"Done replacing {int(bpm.sum())} bad pixels using the "
              "median of neighbors")
        timing(clock)
    return (fixed[0], bpm[0]) if full_output else fixed[0]


def cube_fix_badpix_isolated(array, bpm_mask=None, correct_only=False,
                             sigma_clip=3, num_neig=5, size=5,
                             frame_by_frame=False, protect_mask=0, cxy=None,
                             mad=False, ignore_nan=True, verbose=True,
                             full_output=False, nproc=1, excl_mask=None):
    """Isolated bad-pixel correction of a cube (vip_tpu
    badpixremoval.py:198): one map from the mean frame shared by all
    frames, or with ``frame_by_frame`` one a frame, every frame detected
    in one batched neighbour clip. The bad pixels' medians are gathered at
    the bad pixels alone. Returns the cube (a tensor), and with
    ``full_output`` the map (a bool tensor, 2-d when shared)."""
    if array.ndim != 3:
        raise TypeError("Array is not a 3d array or cube")
    _require_odd_kernel(size)
    _require_map_for_correct_only(correct_only, bpm_mask)
    if bpm_mask is not None:
        bpm_mask = _norm_mask(bpm_mask, array.shape[-2:], "bad pixel mask")
    clock = time_ini() if verbose else None
    cube = _float(array)
    dev = cube.device
    nz = cube.shape[0]
    if cxy is None:
        cy, cx = frame_center(cube[0])
    elif isinstance(cxy, tuple):
        cx, cy = cxy
    elif isinstance(cxy, np.ndarray):
        if cxy.ndim != 2 or cxy.shape != (nz, 2):
            raise ValueError("cxy does not have right shape")
        if not frame_by_frame:
            raise ValueError("cxy must be a tuple or None if not in "
                             "frame_by_frame mode")
        cx, cy = cxy[:, 0], cxy[:, 1]

    if frame_by_frame:
        cxs = _seq_per_frame(cx, nz)
        cys = _seq_per_frame(cy, nz)
        bpm3 = None if bpm_mask is None \
            else _dev_bool(_stack_per_frame(bpm_mask, nz), dev)
        excl3 = torch.zeros(cube.shape, dtype=torch.bool, device=dev) \
            if excl_mask is None else _dev_bool(_host(excl_mask), dev)
        fixed, final_bpm = _isolated_frames(
            cube, bpm3, correct_only, sigma_clip, num_neig, size,
            protect_mask, cys, cxs, mad, ignore_nan, excl3)
        n_fixed = int(final_bpm.sum())
    else:
        if excl_mask is None:
            excl = np.zeros(cube.shape[-2:], dtype=bool)
        elif excl_mask.ndim == 3:
            excl = np.median(_host(excl_mask), axis=0).astype(bool)
        else:
            if tuple(excl_mask.shape) != tuple(cube.shape[-2:]):
                raise AssertionError(
                    "Input exclusion mask should have same last 2 dims as"
                    " array")
            excl = _host(excl_mask).astype(bool)
        if bpm_mask is None or not correct_only:
            if bpm_mask is None:
                seed2d = np.zeros(cube.shape[-2:], dtype=bool)
            elif bpm_mask.ndim == 3:
                seed2d = np.median(bpm_mask, axis=0).astype(bool)
            else:
                seed2d = bpm_mask
            mean_fr = torch.nanmean(cube, dim=0)
            hits = _clip_frames(mean_fr[None], _dev_bool(seed2d | excl,
                                                         dev)[None],
                                sigma_clip, num_neig, mad)[0]
            final_bpm = hits | _dev_bool(seed2d, dev)
            if ignore_nan:
                final_bpm &= ~torch.isnan(mean_fr)
            final_bpm &= ~_dev_bool(_protect_region(
                cy, cx, protect_mask, tuple(final_bpm.shape)), dev)
            final_bpm &= ~_dev_bool(excl, dev)
        elif bpm_mask.ndim == 3:
            final_bpm = _dev_bool(np.median(bpm_mask, axis=0).astype(bool),
                                  dev)
        else:
            final_bpm = _dev_bool(bpm_mask, dev)
        fixed = _replace_by_median(cube, final_bpm.expand(nz, -1, -1),
                                   size)
        n_fixed = nz * int(final_bpm.sum())

    if verbose:
        print(f"Done replacing {n_fixed:.0f} bad pixels using the median "
              "of neighbors")
        timing(clock)
    return (fixed, final_bpm) if full_output else fixed


# ---------------------------------------------------------------------------
# annulus-statistics correction
# ---------------------------------------------------------------------------
def reject_outliers(data, test_value, m=5., stddev=None, debug=False):
    """Robust outlier test (vip_tpu badpixremoval.py:295, the numba
    variant: it compares max(data), not max(|d|), to stddev). Host numpy;
    the plain version of the test in ``_segment_trimmed_stats``."""
    data = np.asarray(_host(data), dtype=float)
    if stddev is None:
        stddev = np.std(data)
    med = np.median(data)
    mdev = np.median(np.abs(data.ravel() - med))
    if debug:
        print("data = ", data)
        print("median(data)= ", med)
        print("mdev = ", mdev)
        print("stddev(box) = ", np.std(data))
        print("stddev(frame) = ", stddev)
    if max(np.max(data), np.abs(test_value - med)) > stddev:
        test = np.abs((test_value - med) / mdev) if mdev > 0 else np.inf
        return 0 if test < m else 1
    return 0


def _trimmed_med_std(values, stddev):
    """Median/std of one annulus after vip_tpu's outlier trim
    (badpixremoval.py:316): at most one extreme value is dropped, the
    minimum tested first, then the maximum. Host numpy; the plain version
    of ``_segment_trimmed_stats``."""
    vals = np.asarray(_host(values), dtype=float)
    if vals.size:
        if reject_outliers(vals, vals.min(), m=5, stddev=stddev):
            vals = np.delete(vals, vals.argmin())
        elif reject_outliers(vals, vals.max(), m=5, stddev=stddev):
            vals = np.delete(vals, vals.argmax())
    if not vals.size:
        return np.nan, np.nan
    return float(np.median(vals)), float(np.std(vals))


def find_outliers(frame, sig_dist, in_bpix=None, stddev=None,
                  neighbor_box=3, min_thr=None, mid_thr=None):
    """Bad-pixel map from a local robust outlier test around each pixel
    (vip_tpu badpixremoval.py:332), host numpy as there."""
    frame = np.asarray(_host(frame))
    assert frame.ndim == 2, "Object is not two dimensional.\n"
    ny, nx = frame.shape
    bpix_map = np.zeros_like(frame)
    if stddev is None:
        stddev = np.std(frame)
    half_box = int(neighbor_box / 2)

    def _test(yy, xx):
        hbox_b = min(half_box, yy)
        hbox_t = min(half_box, ny - 1 - yy)
        hbox_l = min(half_box, xx)
        hbox_r = min(half_box, nx - 1 - xx)
        if yy > ny - 1 - half_box:
            hbox_b = hbox_b + (yy - (ny - 1 - half_box))
        elif yy < half_box:
            hbox_t = hbox_t + (half_box - yy)
        if xx > nx - 1 - half_box:
            hbox_l = hbox_l + (xx - (nx - 1 - half_box))
        elif xx < half_box:
            hbox_r = hbox_r + (half_box - xx)
        neighbours = frame[yy - hbox_b:yy + hbox_t + 1,
                           xx - hbox_l:xx + hbox_r + 1]
        flat_idx = np.ravel_multi_index(
            ([[hbox_b], [hbox_l]]),
            (hbox_t + hbox_b + 1, hbox_r + hbox_l + 1))
        neighbours = np.delete(neighbours, flat_idx)
        return reject_outliers(neighbours, frame[yy, xx], m=sig_dist,
                               stddev=stddev)

    if in_bpix is None:
        for xx in range(nx):
            for yy in range(ny):
                bpix_map[yy, xx] = _test(yy, xx)
    else:
        in_bpix = np.asarray(_host(in_bpix))
        seen = np.zeros_like(in_bpix)
        for y0, x0 in zip(*np.where(in_bpix)):
            for yy in {max(0, y0 - half_box), y0,
                       min(ny - 1, y0 + half_box)}:
                for xx in {max(0, x0 - half_box), x0,
                           min(ny - 1, x0 + half_box)}:
                    seen[yy, xx] = 1
        for yy, xx in zip(*np.where(seen)):
            bpix_map[yy, xx] = _test(yy, xx)
    return bpix_map


def correct_ann_outliers(array, bpix_map, ann_width, sig, med_neig,
                         std_neig, cy, cx, min_thr, max_thr, stddev,
                         half_res_y=False, rand_arr=None):
    """Correct the outliers of a frame against concentric-annulus
    statistics (vip_tpu badpixremoval.py:383) on its device. Without
    ``rand_arr`` the replacement noise is drawn from numpy's global
    generator, as there. Returns the frame and the float map (tensors)."""
    array = _float(array)
    n_y, n_x = array.shape
    if rand_arr is None:
        rand_arr = 2 * (np.random.rand(n_y, n_x) - 0.5)
    fixed, bpm = _correct_ann_frames(
        array[None], as_tensor(_host(bpix_map), array.device)[None] != 0,
        sig, as_tensor(_host(med_neig), array.device,
                                  array.dtype)[None],
        as_tensor(_host(std_neig), array.device, array.dtype)[None],
        _rr_map(cy, cx, (n_y, n_x), ann_width, half_res_y, array.device)[
            None], min_thr, max_thr,
        torch.as_tensor([float(stddev)], dtype=array.dtype,
                        device=array.device),
        as_tensor(np.asarray(_host(rand_arr)), array.device,
                  array.dtype)[None])
    return fixed[0], bpm[0].to(array.dtype)


def _rr_map(cy, cx, shape, ann_width, half_res_y, device):
    """int(radius / ann_width) of every pixel (vip_tpu
    badpixremoval.py:390-395)."""
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    if half_res_y:
        rad = np.sqrt((2 * (cy - yy)) ** 2 + (cx - xx) ** 2)
    else:
        rad = np.sqrt((cy - yy) ** 2 + (cx - xx) ** 2)
    return torch.as_tensor((rad / ann_width).astype(int), device=device)


def _correct_ann_frames(work, known_bad, sig, med_neig, std_neig, rr,
                        min_thr, max_thr, stddev, rand):
    """``correct_ann_outliers`` of a (B, ny, nx) batch: each frame's
    annulus statistics (B, nrad), radius-index map (B, ny, nx), noise
    floor (B,) and noise draws (B, ny, nx)."""
    B = work.shape[0]
    med = torch.gather(med_neig, 1, rr.reshape(B, -1)).reshape(work.shape)
    std = torch.gather(std_neig, 1, rr.reshape(B, -1)).reshape(work.shape)
    dev = torch.maximum(stddev[:, None, None], torch.minimum(std, med))
    bpm = known_bad | (work < min_thr) | (work > max_thr)
    bpm |= (work < med - sig * dev) | (work > med + sig * dev)
    fixed = torch.where(bpm, med + torch.sqrt(torch.abs(med)) * rand, work)
    return fixed, bpm


def _masked_sort(vals, keep):
    """Rows of (B, P) sorted with the dropped values last, and each row's
    kept count."""
    big = torch.where(keep, vals, torch.inf)
    return torch.sort(big, dim=-1).values, keep.sum(dim=-1)


def _row_median(srt, k):
    last = srt.shape[-1] - 1
    lo = torch.gather(srt, 1, ((k - 1).clamp(min=0) // 2).clamp(
        max=last)[:, None])[:, 0]
    hi = torch.gather(srt, 1, (k // 2).clamp(max=last)[:, None])[:, 0]
    return 0.5 * (lo + hi)


def _masked_std(vals, keep, k):
    w = keep.to(vals.dtype)
    kf = k.clamp(min=1).to(vals.dtype)
    mean = (torch.where(keep, vals, 0.0)).sum(dim=-1) / kf
    dev = torch.where(keep, vals - mean[:, None], 0.0)
    return torch.sqrt((dev * dev * w).sum(dim=-1) / kf)


def _clipped_std_batch(samples, sigma=2.5, maxiters=5):
    """:func:`_sigma_clipped_std` of every row of a (B, P) tensor: each
    row clipped about its median until no value goes or after
    ``maxiters`` passes, a row frozen once it stops."""
    keep = torch.isfinite(samples)
    active = torch.ones(samples.shape[0], dtype=torch.bool,
                        device=samples.device)
    for _ in range(maxiters):
        srt, k = _masked_sort(samples, keep)
        med = _row_median(srt, k)
        std = _masked_std(samples, keep, k)
        new = keep & (torch.abs(samples - med[:, None])
                      <= sigma * std[:, None])
        go = active & (new != keep).any(dim=-1)
        keep = torch.where(go[:, None], new, keep)
        active = go
        if not bool(active.any()):
            break
    return _masked_std(samples, keep, keep.sum(dim=-1))


def _segment_sort(values, keys):
    """``values`` sorted by (key, value), both stably: (sorted values,
    their keys)."""
    o1 = torch.sort(values, stable=True).indices
    o2 = torch.sort(keys[o1], stable=True).indices
    order = o1[o2]
    return values[order], keys[order]


def _segment_trimmed_stats(values, keys, n_seg, stddev_of_seg, m=5.):
    """``_trimmed_med_std`` of every segment of a flat list of values with
    segment ``keys`` in [0, n_seg): one segmented sort, numpy's medians,
    the numba outlier test of ``reject_outliers`` on the minimum then the
    maximum against the segment's floor ``stddev_of_seg`` (n_seg,), at
    most one value dropped. Returns (median, std) of each segment, NaN
    where none is left."""
    dt, dev = values.dtype, values.device
    v, k = _segment_sort(values, keys)
    counts = torch.bincount(k, minlength=n_seg)
    starts = torch.cumsum(counts, 0) - counts
    c = counts
    has = c > 0
    last = max(v.numel() - 1, 0)

    def at(i):
        return v[i.clamp(0, last)] if v.numel() else \
            torch.zeros(i.shape, dtype=dt, device=dev)

    med = 0.5 * (at(starts + (c - 1).clamp(min=0) // 2) + at(starts + c // 2))
    d = torch.abs(v - med[k])
    d_sorted, _ = _segment_sort(d, k)
    mdev = 0.5 * (d_sorted[(starts + (c - 1).clamp(min=0) // 2).clamp(
        0, last)] + d_sorted[(starts + c // 2).clamp(0, last)]) \
        if v.numel() else torch.zeros_like(med)
    vmin = at(starts)
    vmax = at(starts + c - 1)

    def reject(test):
        big = torch.maximum(vmax, torch.abs(test - med)) > stddev_of_seg
        stat = torch.where(mdev > 0, torch.abs((test - med) / mdev),
                           torch.inf)
        return big & ~(stat < m) & has

    rej_min = reject(vmin)
    rej_max = ~rej_min & reject(vmax)
    lo = starts + rej_min.long()
    c2 = c - rej_min.long() - rej_max.long()
    med2 = 0.5 * (at(lo + (c2 - 1).clamp(min=0) // 2) + at(lo + c2 // 2))
    pos = torch.arange(v.numel(), device=dev) - starts[k]
    inside = (pos >= rej_min[k].long()) & (pos < (c - rej_max.long())[k])
    # segment sums through a float64 running sum: deterministic on every
    # device, unlike an atomic scatter-add
    v64 = torch.where(inside, v, 0.0).to(torch.float64)
    cs = torch.cat([v64.new_zeros(1), torch.cumsum(v64, 0)])
    ends = starts + c
    kf = c2.clamp(min=1).to(torch.float64)
    mean = (cs[ends] - cs[starts]) / kf
    dd = torch.where(inside, v.to(torch.float64) - mean[k], 0.0)
    cs2 = torch.cat([dd.new_zeros(1), torch.cumsum(dd * dd, 0)])
    std2 = torch.sqrt((cs2[ends] - cs2[starts]) / kf).to(dt)
    empty = c2 == 0
    return (torch.where(empty, torch.nan, med2),
            torch.where(empty, torch.nan, std2))


def _ann_geometry(cy, cx, fwhm, shape, half_res_y, protect_mask):
    """Host geometry of one frame of the annulus correction (vip_tpu
    badpixremoval.py:430-492) on the (possibly row-halved) working frame:
    each pixel's annulus index, the annulus count, the pooled border, the
    radius-index map and the protected zone."""
    ny, nx = shape
    ymax = max(cy, ny - cy) * (2 if half_res_y else 1)
    xmax = max(cx, nx - cx)
    ann_width = max(1.5, 0.5 * fwhm)
    nrad = int(np.sqrt(ymax ** 2 + xmax ** 2) / ann_width) + 1
    if half_res_y:
        d_border = max(2 * (ny - cy), 2 * cy, nx - cx, cx)
    else:
        d_border = max(ny - cy, cy, nx - cx, cx)
    yy_g, xx_g = np.mgrid[:ny, :nx]
    if half_res_y:
        r2 = (2.0 * (yy_g - cy)) ** 2 + (xx_g - cx) ** 2
    else:
        r2 = (yy_g - cy) ** 2.0 + (xx_g - cx) ** 2
    bounds = (np.arange(1, nrad + 1, dtype=float) * ann_width) ** 2
    ann_idx = np.minimum(np.searchsorted(bounds, r2.ravel(), side="right")
                         .reshape(ny, nx), nrad - 1)
    if half_res_y:
        rad = np.sqrt((2 * (cy - yy_g)) ** 2 + (cx - xx_g) ** 2)
    else:
        rad = np.sqrt((cy - yy_g) ** 2 + (cx - xx_g) ** 2)
    return dict(ann_idx=ann_idx, nrad=nrad, rr_limit=int(d_border / ann_width),
                rr=(rad / ann_width).astype(int),
                protected=_protect_region(cy, cx, protect_mask, (ny, nx),
                                          half_res_y))


def _noise_sample_index(shape, cy, cx, fwhm, r_in_std, r_out_std):
    """Host (yy, xx) of the pixels of the noise-floor sample (vip_tpu
    badpixremoval.py:445-456), None for the whole frame."""
    ny, nx = shape
    if not (r_in_std or r_out_std):
        return None
    r_in = min(r_in_std * fwhm, cx - 2, cy - 2, nx - cx - 2, ny - cy - 2)
    if r_out_std:
        r_out = r_out_std * fwhm
    else:
        r_out = min(ny - (cy + r_in), cy - r_in, nx - (cx + r_in), cx - r_in)
    return get_annulus_segments(shape, r_in, max(2, r_out - r_in))[0]


def _ann_removal_frames(frames, cys, cxs, fwhms, sig, protect_mask, seeds,
                        excls, r_in_std, r_out_std, min_thr, max_thr,
                        min_thr_np, half_res_y, verbose):
    """``_ann_removal_2d`` of every frame of a (B, ny, nx) batch (seeds and
    exclusion masks (B, ny, nx) bool tensors): the noise floors and the
    trimmed (frame, annulus) statistics batched, the replacement noise
    drawn on the host frame by frame. Returns (fixed, float map, annulus
    map) tensors."""
    B, ny_full, nx = frames.shape
    dev, dt = frames.device, frames.dtype
    work, excl, seed = frames, excls, seeds
    cys = list(cys)
    if half_res_y:
        if ny_full % 2:
            raise ValueError("The input frames do not have of an even "
                             "number of rows. Hence, you should not use "
                             "option half_res_y = True")
        cys = [int(cy / 2) for cy in cys]
        work, excl, seed = frames[:, ::2], excls[:, ::2], seeds[:, ::2]
    ny = work.shape[1]

    cache = {}
    geoms = []
    for cy, cx, fwhm in zip(cys, cxs, fwhms):
        key = (float(cy), float(cx), float(fwhm))
        if key not in cache:
            cache[key] = _ann_geometry(cy, cx, fwhm, (ny, nx), half_res_y,
                                       protect_mask)
            cache[key]["sample"] = _noise_sample_index(
                (ny, nx), cy, cx, fwhm, r_in_std, r_out_std)
        geoms.append(cache[key])

    # noise floors: each frame's sample, rows padded with NaN
    rows = []
    for b, g in enumerate(geoms):
        rows.append(work[b].reshape(-1) if g["sample"] is None else
                    work[b][torch.as_tensor(g["sample"][0], device=dev),
                            torch.as_tensor(g["sample"][1], device=dev)])
    width = max(r.numel() for r in rows)
    samples = torch.full((B, width), torch.nan, dtype=dt, device=dev)
    for b, r in enumerate(rows):
        samples[b, :r.numel()] = r
    stddev = _clipped_std_batch(samples, sigma=2.5)

    known_bad = excl | seed
    if min_thr_np is not None:
        known_bad = known_bad | (work < min_thr_np)
    valid = ~known_bad

    ann_idx = torch.as_tensor(np.stack([g["ann_idx"] for g in geoms]),
                              device=dev)
    rr_limit = torch.as_tensor([g["rr_limit"] for g in geoms], device=dev)
    nrad = torch.as_tensor([g["nrad"] for g in geoms], device=dev)
    S = int(max(min(g["rr_limit"], g["nrad"] - 1) for g in geoms)) + 2
    fr = torch.arange(B, device=dev)[:, None, None].expand_as(ann_idx)
    own = valid & (ann_idx <= rr_limit[:, None, None])
    pooled = valid & (ann_idx >= rr_limit[:, None, None]) \
        & (nrad - 1 > rr_limit)[:, None, None]
    values = torch.cat([work[own], work[pooled]])
    keys = torch.cat([fr[own] * S + ann_idx[own], fr[pooled] * S + S - 1])
    med_s, std_s = _segment_trimmed_stats(values, keys, B * S,
                                          stddev.repeat_interleave(S))
    med_s, std_s = med_s.reshape(B, S), std_s.reshape(B, S)

    R = int(max(g["nrad"] for g in geoms))
    r_idx = torch.arange(R, device=dev)[None, :]
    in_own = r_idx <= torch.minimum(rr_limit, nrad - 1)[:, None]
    in_pool = (r_idx > rr_limit[:, None]) & (r_idx < nrad[:, None])
    gather_own = torch.gather(med_s, 1, r_idx.clamp(max=S - 1).expand(B, R))
    gstd_own = torch.gather(std_s, 1, r_idx.clamp(max=S - 1).expand(B, R))
    med_neig = torch.where(in_own, gather_own,
                           torch.where(in_pool, med_s[:, -1:], torch.nan))
    std_neig = torch.where(in_own, gstd_own,
                           torch.where(in_pool, std_s[:, -1:], torch.nan))

    rand = torch.as_tensor(np.stack([2 * (np.random.rand(ny, nx) - 0.5)
                                     for _ in range(B)]), dtype=dt,
                           device=dev)
    rr = torch.as_tensor(np.stack([g["rr"] for g in geoms]), device=dev)
    fixed, bpm = _correct_ann_frames(work, known_bad, sig, med_neig,
                                     std_neig, rr, min_thr, max_thr, stddev,
                                     rand)

    protected = torch.as_tensor(np.stack([g["protected"] for g in geoms]),
                                device=dev)
    if verbose:
        n_found = bpm.sum(dim=(1, 2))
        n_corr = n_found - (bpm & protected).sum(dim=(1, 2))
        for b in range(B):
            print("************Frame # ", b, " *************")
            print(int(n_found[b]), " bpix in total, and ", int(n_corr[b]),
                  " corrected.")
    restore = protected if min_thr_np is None \
        else protected & (work >= min_thr_np)
    bpm = bpm & ~restore
    fixed = torch.where(restore, work, fixed)
    ann_frame = torch.where(valid, ann_idx, 0)
    ann_frame = torch.where(pooled, (nrad - 1)[:, None, None], ann_frame)

    if half_res_y:
        fixed = torch.repeat_interleave(fixed, 2, dim=1)[:, :ny_full]
        bpm = torch.repeat_interleave(bpm, 2, dim=1)[:, :ny_full]
        ann_frame = torch.repeat_interleave(ann_frame, 2, dim=1)[:, :ny_full]
    fixed = torch.where(excls, frames, fixed)
    bpm = bpm & ~excls
    return fixed, bpm.to(dt), ann_frame.to(dt)


def _ann_removal_2d(frame_in, cy, cx, fwhm, sig, protect_mask, seed_map,
                    excl_mask, r_in_std, r_out_std, min_thr, max_thr,
                    min_thr_np, half_res_y, verbose):
    """One frame of :func:`cube_fix_badpix_annuli` (vip_tpu
    badpixremoval.py:408): the batched route on a batch of one."""
    frame_in = _float(frame_in)
    if tuple(excl_mask.shape) != tuple(frame_in.shape):
        raise AssertionError(
            "Input exclusion mask should have same shape as array\n")
    dev = frame_in.device
    seed = np.zeros(frame_in.shape, bool) if seed_map is None \
        else _host(seed_map).astype(bool)
    out = _ann_removal_frames(
        frame_in[None], [cy], [cx], [fwhm], sig, protect_mask,
        _dev_bool(seed, dev)[None],
        _dev_bool(_host(excl_mask).astype(bool), dev)[None], r_in_std,
        r_out_std, min_thr, max_thr, min_thr_np, half_res_y, False)
    if verbose:
        print(int(out[1].sum()), " bpix in total.")
    return tuple(o[0] for o in out)


def cube_fix_badpix_annuli(array, fwhm, cy=None, cx=None, sig=5.,
                           bpm_mask=None, protect_mask=0, excl_mask=None,
                           r_in_std=50, r_out_std=None, verbose=True,
                           half_res_y=False, min_thr=None, max_thr=None,
                           min_thr_np=None, bad_values=None,
                           full_output=False):
    """Identify and correct bad pixels against concentric-annulus
    statistics (vip_tpu badpixremoval.py:520): every frame's noise floor,
    annulus statistics and correction at once; the replacement noise
    drawn from numpy's global generator frame by frame, as vip_tpu draws
    it. Returns the frame or cube (a tensor), and with ``full_output`` the
    bad-pixel and annulus maps."""
    ndims = array.ndim
    assert ndims in (2, 3), "Object is not two or three dimensional.\n"
    arr = _float(array)
    dev = arr.device
    if min_thr is None:
        min_thr = float(torch.min(arr)) - 1
    if max_thr is None:
        max_thr = float(torch.max(arr)) - 1
    if bpm_mask is not None:
        bpm_mask = _norm_mask(bpm_mask, arr.shape[-2:], "bad pixel mask")
    bpm_mask = _seed_from_values(arr, bad_values, bpm_mask)
    if cy is None or cx is None:
        cy, cx = frame_center(arr)

    if ndims == 2:
        excl = np.zeros(arr.shape, bool) if excl_mask is None \
            else excl_mask
        return_ = _ann_removal_2d(arr, cy, cx, fwhm, sig, protect_mask,
                                  bpm_mask, excl, r_in_std, r_out_std,
                                  min_thr, max_thr, min_thr_np, half_res_y,
                                  verbose)
        fixed, bpix_map, ann_frame = return_
    else:
        nz = arr.shape[0]
        fwhm = _seq_per_frame(fwhm, nz)
        if np.isscalar(cx) and np.isscalar(cy):
            cy, cx = [cy] * nz, [cx] * nz
        seeds = np.zeros(arr.shape, bool) if bpm_mask is None \
            else _stack_per_frame(bpm_mask, nz)
        excls = np.zeros(arr.shape, bool) if excl_mask is None \
            else _stack_per_frame(excl_mask, nz)
        fixed, bpix_map, ann_frame = _ann_removal_frames(
            arr, cy, cx, fwhm, sig, protect_mask,
            _dev_bool(seeds.astype(bool), dev),
            _dev_bool(excls.astype(bool), dev), r_in_std, r_out_std,
            min_thr, max_thr, min_thr_np, half_res_y, verbose)
    if full_output:
        return fixed, bpix_map, ann_frame
    return fixed


# ---------------------------------------------------------------------------
# clump correction (iterative sigma filter)
# ---------------------------------------------------------------------------
def _clump_frames(frames, cys, cxs, fwhms, sig, protect_mask, seeds, excls,
                  min_thr, max_nit, half_res_y, mad, verbose):
    """``_clump_removal_2d`` of every frame of a (B, ny, nx) batch: the
    detect, sigma-filter, re-detect loop on all frames at once, each frame
    frozen once it has no bad pixel left (so each keeps vip_tpu's
    iteration count). Returns the frames and the cumulated maps."""
    B, ny_full, nx = frames.shape
    dev = frames.device
    work, excl, seed = frames, excls, seeds
    if half_res_y:
        if ny_full % 2:
            raise ValueError("The input frames do not have of an even "
                             "number of rows. Hence, you should not use "
                             "option half_res_y = True")
        work, excl, seed = frames[:, ::2], excls[:, ::2], seeds[:, ::2]
    work = work.clone()
    ny = work.shape[1]
    boxes = []
    for fwhm in fwhms:
        fwhm_round = int(round(fwhm))
        boxes.append(max(3, fwhm_round + 1 if fwhm_round % 2 == 0
                         else fwhm_round))
    if min_thr is not None:
        if np.isscalar(min_thr):
            min_thr = (-min_thr, min_thr)
        elif not isinstance(min_thr, tuple) or len(min_thr) != 2:
            raise ValueError("if provided, min_thr should be float or "
                             "2-element tuple")
    keep_out = _protect_stack([int(cy / 2) if half_res_y else cy
                               for cy in cys], cxs, protect_mask, (ny, nx),
                              half_res_y, dev)

    def _detect(idx, prior):
        img = work[idx]
        found = torch.empty(img.shape, dtype=torch.bool, device=dev)
        pri = torch.zeros_like(found) if prior is None else prior[idx]
        bx = [boxes[i] for i in idx.tolist()]
        for box in sorted(set(bx)):
            sel = torch.as_tensor([j for j, b in enumerate(bx) if b == box],
                                  device=dev)
            found[sel] = _clip_frames(img[sel], pri[sel], sig, box, mad,
                                      half_res_y)
        if min_thr is not None:
            found &= ~((img > min_thr[0]) & (img < min_thr[1]))
        n_all = found.sum(dim=(1, 2))
        return found & ~keep_out[idx] & ~excl[idx], n_all

    everyone = torch.arange(B, device=dev)
    bad, n_all = _detect(everyone, excl | seed)
    cumulative = bad.clone()
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for nit in range(1, max_nit + 1):
        active = active & bad.any(dim=(1, 2))
        idx = torch.nonzero(active).reshape(-1)
        if not idx.numel():
            break
        if verbose:
            print(f"Iteration {nit}: {int(n_all[idx].sum())} bad pixels "
                  f"identified in {idx.numel()} frames")
        if min(ny, nx) >= 3:
            work[idx] = cube_sigma_filter_device(work[idx], bad[idx],
                                                 min_neighbors=3)[0]
        else:
            from ..stats.clip_sigma import sigma_filter

            for i in idx.tolist():
                work[i] = sigma_filter(work[i], bad[i])
        new, n_new = _detect(idx, None)
        bad[idx] = new
        n_all[idx] = n_new
        cumulative[idx] |= new
    if verbose:
        print("All bad pixels are corrected.")
    if half_res_y:
        work = torch.repeat_interleave(work, 2, dim=1)
        cumulative = torch.repeat_interleave(cumulative, 2, dim=1)
    return work, cumulative


def _clump_removal_2d(frame, cy, cx, fwhm, sig, protect_mask, seed_map,
                      excl_mask, min_thr, max_nit, half_res_y, mad,
                      verbose):
    """One frame of :func:`cube_fix_badpix_clump` (vip_tpu
    badpixremoval.py:577): the batched route on a batch of one."""
    frame = _float(frame)
    if tuple(excl_mask.shape) != tuple(frame.shape):
        raise AssertionError(
            "Input exclusion mask should have same shape as array\n")
    dev = frame.device
    seed = np.zeros(frame.shape, bool) if seed_map is None \
        else _host(seed_map).astype(bool)
    work, cum = _clump_frames(
        frame[None], [cy], [cx], [fwhm], sig, protect_mask,
        _dev_bool(seed, dev)[None],
        _dev_bool(_host(excl_mask).astype(bool), dev)[None], min_thr,
        max_nit, half_res_y, mad, verbose)
    return work[0], cum[0]


def cube_fix_badpix_clump(array, bpm_mask=None, correct_only=False, cy=None,
                          cx=None, fwhm=4., sig=4., protect_mask=0,
                          excl_mask=None, half_res_y=False, min_thr=None,
                          max_nit=15, mad=True, bad_values=None,
                          verbose=True, full_output=False, debug=True,
                          nproc=1):
    """Iteratively identify and correct clumps of bad pixels (vip_tpu
    badpixremoval.py:652), all frames of a cube at once. Returns the frame
    or cube (a tensor), and with ``full_output`` the cumulated map."""
    from ..stats.clip_sigma import cube_sigma_filter, sigma_filter

    out = _float(array).clone()
    dev = out.device
    ndims = out.ndim
    assert ndims in (2, 3), "Object is not two or three dimensional.\n"
    _require_map_for_correct_only(correct_only, bpm_mask)
    bpm_mask = _seed_from_values(out, bad_values, bpm_mask)
    detect = bpm_mask is None or not correct_only

    if ndims == 2:
        if detect:
            # vip_tpu takes the center only with a protected zone, and then
            # fails on a None center with half_res_y (ROADMAP Queue 3)
            if cy is None or cx is None:
                cy, cx = frame_center(out)
            excl = np.zeros(out.shape, bool) if excl_mask is None \
                else excl_mask
            out, bad_total = _clump_removal_2d(
                out, cy, cx, fwhm, sig, protect_mask, bpm_mask, excl,
                min_thr, max_nit, half_res_y, mad, verbose)
        else:
            box, nneig = _clump_kernel_geom(fwhm)
            out = sigma_filter(out, _dev_bool(_host(bpm_mask), dev), box,
                               nneig, half_res_y, verbose)
            bad_total = _dev_bool(_host(bpm_mask), dev)
        if full_output:
            return out, bad_total
        return out

    nz = out.shape[0]
    if detect:
        seeds = np.zeros(out.shape, bool) if bpm_mask is None \
            else _stack_per_frame(_host(bpm_mask).astype(bool), nz)
        excls = np.zeros(out.shape, bool) if excl_mask is None \
            else _stack_per_frame(excl_mask, nz)
        if cy is None or cx is None:
            cy, cx = frame_center(out)
        out, bad_total = _clump_frames(
            out, _seq_per_frame(cy, nz), _seq_per_frame(cx, nz),
            _seq_per_frame(fwhm, nz), sig, protect_mask,
            _dev_bool(seeds, dev), _dev_bool(_host(excls).astype(bool), dev),
            min_thr, max_nit, half_res_y, mad, verbose)
        bad_total = bad_total.to(out.dtype)
    else:
        bpm3 = _dev_bool(_stack_per_frame(_host(bpm_mask).astype(bool), nz),
                         dev)
        # one batched sigma filter over the frames (the box/nneig
        # arguments are ignored by sigma_filter, vip_tpu
        # badpixremoval.py:709-715)
        out = cube_sigma_filter(out, bpm3, verbose=verbose)
        bad_total = bpm3
    if full_output:
        return out, bad_total
    return out


# ---------------------------------------------------------------------------
# IFS (SDI-residual) detection
# ---------------------------------------------------------------------------
def _zoom_operators(dim, scales, device):
    """The exact FFT zoom ``scale_fft(·, s, ori_dim=True)`` of an even
    dim² frame as (R0, g, h) operators (``rescaling.scale_fft_matrix``),
    one a scale, built at once on the device in float64: (P, dim, dim),
    (P, dim), (P, dim). The phases are reduced modulo the canvas exactly
    in integers."""
    from .rescaling import _kdkf

    P = len(scales)
    geo = np.array([_kdkf(dim, s) for s in scales])            # (P, 2)
    kd, kf = geo[:, 0], geo[:, 1]
    dim_p, dim_pp = dim + 2 * kd, dim + 2 * kf
    dmin = np.minimum(dim_p, dim_pp)
    K = int(dmin.max())
    kk = np.arange(-(K // 2), K // 2)
    kvalid = (kk[None, :] >= -(dmin[:, None] // 2)) \
        & (kk[None, :] < dmin[:, None] // 2)
    m = np.arange(dim)
    u = m[None, :] + kf[:, None]                               # (P, dim)

    def t(a):
        return torch.as_tensor(a, device=device)

    tk, tu, tm = t(kk), t(u), t(m)
    tpp, tp = t(dim_pp)[:, None, None], t(dim_p)[:, None, None]
    # exp(2πi u k / dim_pp) and exp(-2πi k (m + kd) / dim_p), the integer
    # products reduced modulo the canvases before the float64 phase
    a_out = torch.remainder(tu[:, :, None] * tk[None, None, :], tpp)
    a_in = torch.remainder(tk[None, :, None]
                           * (tm[None, None, :] + t(kd)[:, None, None]), tp)
    ph_out = (2 * np.pi) * a_out.to(torch.float64) / tpp
    ph_in = (-2 * np.pi) * a_in.to(torch.float64) / tp
    kv = t(kvalid)
    E_out = torch.polar(kv[:, None, :].to(torch.float64), ph_out)
    E_in = torch.polar(kv[:, :, None].to(torch.float64), ph_in)
    R0 = torch.matmul(E_out, E_in).real / tpp
    k0 = t(-(dmin // 2))[:, None]
    a = torch.remainder(k0 * tu, t(dim_pp)[:, None]).to(torch.float64)
    b = torch.remainder(k0 * (tm[None, :] + t(kd)[:, None]),
                        t(dim_p)[:, None]).to(torch.float64)
    sin_a = torch.sin(2 * np.pi * a / t(dim_pp)[:, None])
    sin_b = torch.sin(-2 * np.pi * b / t(dim_p)[:, None])
    alt_kd = torch.where((tm[None, :] + t(kd)[:, None]) % 2 == 0, 1.0, -1.0)
    alt_kf = torch.where((tm[None, :] + t(kf)[:, None]) % 2 == 0, 1.0, -1.0)
    first = t(dmin == dim_p)[:, None]
    g = torch.where(first, sin_a / t(dim_pp)[:, None],
                    alt_kf.to(torch.float64) / t(dim_pp)[:, None])
    h = torch.where(first, alt_kd.to(torch.float64), sin_b)
    invalid = (tu < 0) | (tu >= t(dim_pp)[:, None])
    R0 = torch.where(invalid[:, :, None], 0.0, R0)
    g = torch.where(invalid, 0.0, g)
    return R0, g, h


def _sdi_pairs(nz):
    """(z, zp) of every ordered pair of distinct channels, z major."""
    return [(z, zp) for z in range(nz) for zp in range(nz) if zp != z]


def _sdi_diffs_batched(chans, scal_vec, flux_vec):
    """The (z, z - 1, y, x) flux- and scale-matched differences of
    ``_sdi_residuals`` (vip_tpu badpixremoval.py:740-746): each channel
    pair's zoom applied as its exact operator ``R0 f R0ᵀ − (hᵀ f h) g gᵀ``
    in batched matrix products, the input rounded to float32 first as
    ``scale_fft``'s canvas does. Pairs in chunks under the 8 GiB budget."""
    nz, dim = chans.shape[0], chans.shape[-1]
    dt, dev = chans.dtype, chans.device
    pairs = _sdi_pairs(nz)
    diffs = chans.new_empty((nz, nz - 1, dim, dim))
    # a pair's two complex128 (dim, 2 dim) phase matrices, its float64
    # operator and its frames
    per_pair = 2 * dim * 2 * dim * 16 + dim * dim * (
        3 * 8 + 4 * chans.element_size())
    chunk = max(1, min(len(pairs), (8 << 30) // per_pair))
    for s in range(0, len(pairs), chunk):
        blk = pairs[s:s + chunk]
        scales = [scal_vec[zp] / scal_vec[z] for z, zp in blk]
        ratio = torch.as_tensor([flux_vec[zp] / flux_vec[z] for z, zp in blk],
                                dtype=dt, device=dev)
        src = torch.as_tensor([zp for _, zp in blk], device=dev)
        f = (ratio[:, None, None] * chans[src]).to(torch.float32)
        R0, g, h = _zoom_operators(dim, scales, dev)
        one = torch.as_tensor([s_ == 1 for s_ in scales], device=dev)
        f = f.to(torch.float64) if dt == torch.float64 else f
        R0, g, h = (v.to(f.dtype) for v in (R0, g, h))
        corr = torch.einsum("pi,pij,pj->p", h, f, h)
        zoom = R0 @ f @ R0.transpose(-1, -2) \
            - corr[:, None, None] * (g[:, :, None] * g[:, None, :])
        # scale 1 is returned as it is, before any float32 rounding
        zoom = torch.where(one[:, None, None],
                           ratio[:, None, None] * chans[src], zoom.to(dt))
        z_of = torch.as_tensor([z for z, _ in blk], device=dev)
        j_of = torch.as_tensor([zp - (zp > z) for z, zp in blk], device=dev)
        diffs[z_of, j_of] = chans[z_of] - zoom
    return diffs


def _sdi_diffs_plain(chans, scal_vec, flux_vec, ref_xy, imlib,
                     interpolation):
    """The plain version of :func:`_sdi_diffs_batched`: vip_tpu's loop of
    one ``frame_rescaling`` a pair."""
    from .rescaling import frame_rescaling

    nz = chans.shape[0]
    diffs = chans.new_empty((nz, nz - 1) + tuple(chans.shape[1:]))
    for z, zp in _sdi_pairs(nz):
        diffs[z, zp - (zp > z)] = chans[z] - frame_rescaling(
            (flux_vec[zp] / flux_vec[z]) * chans[zp], ref_xy=ref_xy,
            scale=scal_vec[zp] / scal_vec[z], imlib=imlib,
            interpolation=interpolation)
    return diffs


def _median_axis0(stack, propagate):
    """The median along axis 0 of a 3-d stack: CUDA kernel H1 on a float32
    CUDA tensor (the gate read at call time, as the collapses read it),
    the plain sort-based median otherwise."""
    from ..ops.median import nanmedian_axis0, nanmedian_plain
    from . import subsampling

    if subsampling.nanmedian_supported(stack):
        return nanmedian_axis0(stack.contiguous(), propagate=propagate)
    return nanmedian_plain(stack, 0, propagate=propagate)


def _batched_zoom_applies(chans, imlib):
    dim = chans.shape[-1]
    return (imlib == "vip-fft" and chans.shape[-2] == dim and dim % 2 == 0
            and not bool(torch.isnan(chans).any()))


def cube_fix_badpix_ifs(array, lbdas, fluxes=None, mask=None, cy=None,
                        cx=None, clumps=True, sigma_clip=3, num_neig=5,
                        size=5, protect_mask=0, mad=False,
                        fwhm=4, min_thr=None, max_nit=15, ignore_nan=True,
                        verbose=True, full_output=False, imlib="vip-fft",
                        interpolation="lanczos4"):
    """Identify bad pixels in IFS cubes from SDI residuals (vip_tpu
    badpixremoval.py:722): each channel against the median of the other
    channels flux- and scale-matched to it (the z·(z − 1) zooms batched,
    every channel's median in one H1 launch with ``propagate=True`` on the
    card), then the clump (or isolated) detection on the residuals and
    the isolated correction of the channels. A 4-d cube loops over its
    frames, one 3-d pass each, as vip_tpu does. Returns the cube (a
    tensor), and with ``full_output`` the maps and residuals."""
    from .rescaling import find_scal_vector

    cube = _float(array)

    def _sdi_residuals(chans):
        flx = [1] * len(lbdas) if fluxes is None else fluxes
        scal_vec, flux_vec = find_scal_vector(
            chans, lbdas, flx, mask=mask, nfp=2, fm="sum", imlib=imlib,
            interpolation=interpolation)
        if _batched_zoom_applies(chans, imlib):
            diffs = _sdi_diffs_batched(chans, scal_vec, flux_vec)
        else:
            diffs = _sdi_diffs_plain(chans, scal_vec, flux_vec, ref_xy,
                                     imlib, interpolation)
        nz, ny, nx = chans.shape
        stack = diffs.permute(1, 0, 2, 3).reshape(nz - 1, nz * ny, nx)
        return _median_axis0(stack, True).reshape(nz, ny, nx)

    if cy is None or cx is None:
        cxy = ref_xy = None
    else:
        cy, cx = frame_center(cube)
        cxy = ref_xy = (cx, cy)

    def _detect_and_fix(chans, cyi, cxi, cxyi):
        res = _sdi_residuals(chans)
        if clumps:
            _, bpm = cube_fix_badpix_clump(
                res, bpm_mask=None, cy=cyi, cx=cxi, fwhm=fwhm,
                sig=sigma_clip, protect_mask=protect_mask, verbose=verbose,
                min_thr=min_thr, max_nit=max_nit, mad=mad,
                full_output=True)
        else:
            _, bpm = cube_fix_badpix_isolated(
                res, bpm_mask=None, sigma_clip=sigma_clip,
                num_neig=num_neig, size=size, frame_by_frame=True,
                protect_mask=protect_mask, cxy=cxyi, mad=mad,
                ignore_nan=ignore_nan, verbose=verbose, full_output=True)
        bpm = torch.clamp(bpm.to(torch.int64), 0, 1)
        fixed = cube_fix_badpix_isolated(
            chans, bpm_mask=_host(bpm), sigma_clip=sigma_clip,
            num_neig=num_neig, size=size, frame_by_frame=True,
            protect_mask=protect_mask, cxy=cxyi, mad=mad,
            ignore_nan=ignore_nan, verbose=verbose, full_output=False)
        return fixed, bpm, res

    if cube.ndim == 3:
        array_out, final_bpm, array_res = _detect_and_fix(cube, cy, cx,
                                                          cxy)
    elif cube.ndim == 4:
        nt = cube.shape[1]
        array_out = torch.zeros_like(cube)
        array_res = torch.zeros_like(cube)
        final_bpm = torch.zeros(cube.shape, dtype=torch.int64,
                                device=cube.device)
        for i in range(nt):
            if verbose:
                print(f"************ Cube #{i + 1}/{nt} *************")
            array_out[:, i], final_bpm[:, i], array_res[:, i] = \
                _detect_and_fix(cube[:, i], cy, cx, cxy)
    else:
        raise TypeError("Input array should be 3D or 4D")

    if full_output:
        return array_out, final_bpm, array_res
    return array_out


# ---------------------------------------------------------------------------
# FFT interpolation ([AAC01])
# ---------------------------------------------------------------------------
# the end of the [AAC01] loop is read back every _FFT_CHECK iterations
_FFT_CHECK = 16


def _roll_gather(W, r0, r1):
    """``np.roll(W[b], (r0[b], r1[b]), axis=(0, 1))`` of every frame of a
    (B, ny, nx) tensor, as two gathers with per-frame offsets."""
    B, ny, nx = W.shape
    dev = W.device
    iy = torch.remainder(torch.arange(ny, device=dev)[None, :]
                         - r0[:, None], ny)
    ix = torch.remainder(torch.arange(nx, device=dev)[None, :]
                         - r1[:, None], nx)
    rows = torch.gather(W, 1, iy[:, :, None].expand(B, ny, nx))
    return torch.gather(rows, 2, ix[:, None, :].expand(B, ny, nx))


def _fft_fill_frames(frames, masks, nit, tol, pad_fac, full_output):
    """The [AAC01] iteration of :func:`frame_fix_badpix_fft` on every
    frame of a (B, ny, nx) batch at once (vip_tpu badpixremoval.py:803),
    each frame frozen once its ``Eg < tol``. Returns (results, spectra,
    iterations): a (B, ny, nx) tensor each (lists of them a frame when
    ``nit`` is a list of snapshot iterations), and each frame's iteration
    count (numpy)."""
    from .cosmetics import frame_pad

    snapshots_at = sorted(set(nit)) if isinstance(nit, list) else None
    nit_max = max(nit) if snapshots_at else nit
    B, ini_y, ini_x = frames.shape
    dev, dt = frames.device, frames.dtype
    fac = (int(pad_fac * ini_x / ini_y), pad_fac)
    _, (y0, y1, x0, x1) = frame_pad(frames[0], fac, keep_parity=False,
                                    fillwith=0, full_output=True)
    probe = frame_pad(frames[0], fac, keep_parity=False, fillwith=0)
    ny, nx = probe.shape
    w = frames.new_zeros((B, ny, nx))
    w[:, y0:y1, x0:x1] = 1 - masks.to(dt)
    g = frames.new_zeros((B, ny, nx))
    g[:, y0:y1, x0:x1] = frames
    g = g * w
    G = torch.fft.fft2(g)
    W = torch.fft.fft2(w)
    npix = float(ny * nx)
    F_est = torch.zeros_like(G)
    half = nx // 2
    ar = torch.arange(B, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    fin_it = torch.full((B,), nit_max - 1, dtype=torch.int64, device=dev)
    cy, cx = frame_center((ny, nx))
    hy, hx = (ini_y - 1) / 2, (ini_x - 1) / 2
    ys = slice(int(cy - hy), int(cy + hy + 1))
    xs = slice(int(cx - hx), int(cx + hx + 1))

    def snapshot():
        rec = torch.fft.ifft2(F_est).real
        return (g + rec * (1 - w))[:, ys, xs], rec[:, ys, xs]

    snaps = {}
    Eg = None
    for it in range(nit_max):
        amax = torch.argmax(torch.abs(G.real[:, :, :half]).reshape(B, -1),
                            dim=1)
        i0 = torch.div(amax, half, rounding_mode="floor")
        i1 = amax % half
        self_conj = ((i0 == 0) | (2 * i0 == ny)) \
            & ((i1 == 0) | (2 * i1 == nx))
        Gi = G[ar, i0, i1]
        W00 = W[:, 0, 0]
        k0, k1 = (2 * i0) % ny, (2 * i1) % nx
        w2 = W[ar, k0, k1]
        degenerate = active & ~self_conj \
            & (torch.abs(W00) ** 2 == torch.abs(w2) ** 2)
        bump = torch.abs(W).reshape(B, -1).amin(dim=1) * 1e-11
        W[ar, k0, k1] = w2 + torch.where(degenerate, bump, 0.0).to(W.dtype)
        w2 = W[ar, k0, k1]
        denom = torch.abs(W00) ** 2 - torch.abs(w2) ** 2
        F_nc = (npix / denom) * (Gi * W00 - torch.conj(Gi) * w2)
        F_sc = npix * Gi / W00
        F_i = torch.where(active, torch.where(self_conj, F_sc, F_nc), 0.0)
        F_c = torch.where(self_conj, 0.0, torch.conj(F_i))
        F_est[ar, i0, i1] += F_i
        j0, j1 = (ny - i0) % ny, (nx - i1) % nx
        F_est[ar, j0, j1] += F_c
        conv = F_i[:, None, None] * _roll_gather(W, i0, i1) \
            + F_c[:, None, None] * _roll_gather(W, -i0, -i1)
        G = G - conv / npix
        Eg = (torch.abs(G) ** 2).reshape(B, -1).sum(dim=1) / npix
        done = active & (Eg < tol)
        fin_it = torch.where(done, it, fin_it)
        active = active & ~done
        if snapshots_at and it in snapshots_at:
            snaps[it] = snapshot()
        if (it + 1) % _FFT_CHECK == 0 and not bool(active.any()):
            break

    final = snapshot()
    fin = fin_it.cpu().numpy()
    if snapshots_at is None:
        return final[0], final[1], fin + 1
    results, spectra = [], []
    for b in range(B):
        its = [i for i in snapshots_at if i <= fin[b]]
        res = [snaps[i][0][b] for i in its if i != fin[b]] + [final[0][b]]
        spe = [snaps[i][1][b] for i in its if i != fin[b]] + [final[1][b]]
        results.append(res)
        spectra.append(spe)
    return results, spectra, fin + 1


def frame_fix_badpix_fft(array, bpm_mask, nit=500, tol=1, pad_fac=2,
                         verbose=True, full_output=False):
    """Iterative FFT-based bad-pixel interpolation ([AAC01]; vip_tpu
    badpixremoval.py:803) on the frame's device. ``nit`` is the iteration
    count, or a list of iterations whose snapshots are returned. Returns
    the filled frame (a list of frames for a list ``nit``), and with
    ``full_output`` the reconstructed spectra's frames."""
    if array.ndim != 2:
        raise TypeError("Input array should be 2D")
    if tuple(array.shape) != tuple(bpm_mask.shape):
        raise TypeError("Input bad pixel map should have same shape as "
                        "array")
    frame = _float(array)
    clock = time_ini() if verbose else None
    res, spe, its = _fft_fill_frames(
        frame[None], as_tensor(_host(bpm_mask), frame.device)[None] != 0,
        nit, tol, pad_fac, full_output)
    if verbose:
        print(f"FFT-interpolation terminated after {int(its[0])} "
              "iterations")
        timing(clock)
    return (res[0], spe[0]) if full_output else res[0]


def cube_fix_badpix_interp(array, bpm_mask, mode="fft", excl_mask=None,
                           fwhm=4., kernel_sz=None, psf=None,
                           half_res_y=False, nit=500, tol=1, nproc=1,
                           full_output=False, **kwargs):
    """Correct bad pixels by interpolation: a Gaussian or PSF convolution
    of the frames with holes ('gauss', 'psf'; one batched low-pass call
    when every frame shares ``fwhm`` and ``psf``), or the iterative FFT
    fill ([AAC01], every frame at once) (vip_tpu badpixremoval.py:886).
    Returns the frame or cube (a tensor), and with ``full_output`` in
    'fft' mode the reconstructed frames."""
    from ..var.filters import cube_filter_lowpass, frame_filter_lowpass

    ndims = array.ndim
    assert ndims in (2, 3), "Object is not two or three dimensional.\n"
    if tuple(bpm_mask.shape[-2:]) != tuple(array.shape[-2:]):
        raise TypeError("Bad pixel map has wrong y/x dimensions.")
    arr = _float(array)
    dev = arr.device
    if excl_mask is None:
        excl = np.zeros(arr.shape, dtype=bool)
    else:
        excl = (_stack_per_frame(excl_mask, arr.shape[0])
                if ndims == 3 else _host(excl_mask))
        if tuple(excl.shape[-2:]) != tuple(arr.shape[-2:]):
            raise AssertionError(
                "Input exclusion mask should have same shape as array\n")
        excl = excl.astype(bool)
    bpm_host = _host(bpm_mask)
    if not np.sum(bpm_host):
        print("Warning: no bad pixel found in bad pixel map. Returning "
              "input array as is.")
        return arr
    if ndims == 3:
        nz = arr.shape[0]
        bpm_host = _stack_per_frame(bpm_host, nz)
    bad = _dev_bool(bpm_host.astype(bool), dev)
    exc = _dev_bool(excl, dev)

    if mode != "fft":
        holes = arr.masked_fill(bad | exc, torch.nan)
        if ndims == 2:
            recon = frame_filter_lowpass(
                holes, mode=mode, fwhm_size=fwhm, conv_mode="conv",
                kernel_sz=kernel_sz, psf=psf, iterate=True,
                half_res_y=half_res_y, **kwargs)
        else:
            fwhms = _seq_per_frame(fwhm, nz)
            psfs = [None] * nz if psf is None else (
                [psf] * nz if np.asarray(_host(psf)).ndim == 2 else psf)
            shared = all(np.array_equal(np.asarray(f), np.asarray(fwhms[0]))
                         for f in fwhms) and (
                psf is None or np.asarray(_host(psf)).ndim == 2)
            if shared:
                recon = cube_filter_lowpass(
                    holes, mode=mode, fwhm_size=fwhms[0], conv_mode="conv",
                    kernel_sz=kernel_sz, psf=psfs[0], iterate=True,
                    half_res_y=half_res_y, **kwargs)
            else:
                recon = torch.stack([frame_filter_lowpass(
                    holes[z], mode=mode, fwhm_size=fwhms[z],
                    conv_mode="conv", kernel_sz=kernel_sz, psf=psfs[z],
                    iterate=True, half_res_y=half_res_y, **kwargs)
                    for z in range(nz)])
        return torch.where(bad, recon, arr)

    fill_mask = bad | exc
    if ndims == 2:
        res = _fft_fill_frames(arr[None], fill_mask[None], nit, tol, 2,
                               full_output)
        filled, recon = res[0][0], res[1][0]
    else:
        filled, recon, _ = _fft_fill_frames(arr, fill_mask, nit, tol, 2,
                                            full_output)
    out = torch.where(bad, filled, arr)
    if full_output:
        return out, recon
    return out


def get_err_spec(F_i, W, ind, npix, G_i, dims):
    """Error-spectrum update of the FFT-based bad-pixel interpolation
    (vip_tpu badpixremoval.py:964): subtract the contribution of the
    Fourier component ``F_i`` at frequency ``ind`` (and its Hermitian
    partner unless self-conjugate) from the error spectrum ``G_i``, as two
    rolls of the window spectrum ``W``. Returns a tensor."""
    ny, nx = dims
    W = W if isinstance(W, torch.Tensor) else torch.as_tensor(np.asarray(W))
    G_i = G_i if isinstance(G_i, torch.Tensor) \
        else torch.as_tensor(np.asarray(G_i), device=W.device)
    self_conj = (ind[0] % (ny / 2) == 0) and (ind[1] % (nx / 2) == 0)
    conv = F_i * torch.roll(W, (int(ind[0]), int(ind[1])), dims=(0, 1))
    if not self_conj:
        conv = conv + np.conj(F_i) * torch.roll(
            W, (-int(ind[0]), -int(ind[1])), dims=(0, 1))
    return G_i - conv / float(npix)

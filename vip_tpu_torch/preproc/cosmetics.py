"""Frame and cube cosmetics: cropping, padding, dropping frames, stripes,
NaN correction and the approximate star position (port of
``vip_tpu.preproc.cosmetics``).

A crop is an index operation: numpy input gives a numpy view, a tensor a
tensor view on its own device. The other functions return tensors on the
input's device (numpy input on :func:`~vip_tpu_torch.get_device`).
``cube_correct_nan`` corrects every frame of a cube in one batched sigma
filter (``ops.badpix``), where vip_tpu maps its per-frame filter over
the frames.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..var.coords import frame_center
from ..var.shapes import get_square

__all__ = ["frame_crop", "cube_crop_frames", "frame_pad", "cube_drop_frames",
           "frame_remove_stripes", "cube_correct_nan",
           "approx_stellar_position"]


def cube_crop_frames(array, size, xy=None, force=False, verbose=True,
                     full_output=False):
    """Crop the frames of a 3d or 4d cube to ``size`` px around ``xy``
    (x, y) or the frame center (vip_tpu cosmetics.py:15). Unless
    ``force``, the size takes the parity of the frames. With
    ``full_output`` also the (cenx, ceny) of the crop."""
    if array.ndim == 3:
        temp_fr = array[0]
    elif array.ndim == 4:
        temp_fr = array[0, 0]
    else:
        raise TypeError("`Array` is not a cube (3d or 4d numpy.ndarray)")

    if temp_fr.shape[0] == size and temp_fr.shape[1] == size:
        if verbose:
            print("Frame size already matches crop size. No cropping needed.")
        if full_output:
            ceny, cenx = frame_center(temp_fr)
            return array, cenx, ceny
        return array

    if xy is not None:
        cenx, ceny = xy
    else:
        ceny, cenx = frame_center(temp_fr)
    _, y0, x0 = get_square(temp_fr, size, y=ceny, x=cenx, position=True,
                           force=force, verbose=verbose)
    if not force:
        if temp_fr.shape[0] % 2 == 0:
            if size % 2 != 0:
                size += 1
        elif size % 2 == 0:
            size += 1
    y1 = int(y0 + size)
    x1 = int(x0 + size)
    array_out = array[..., y0:y1, x0:x1]
    if verbose:
        print(f"New shape: {tuple(array_out.shape)}")
    if full_output:
        return array_out, cenx, ceny
    return array_out


def frame_crop(array, size, xy=None, force=False, verbose=True):
    """Square subframe of ``size`` px around ``xy`` (x, y) or the frame
    center (vip_tpu cosmetics.py:63)."""
    if array.ndim != 2:
        raise TypeError("`Array` is not a frame or 2d array")
    if array.shape[0] == size and array.shape[1] == size:
        if verbose:
            print("Frame size already matches crop size. No cropping needed.")
        return array
    if not xy:
        ceny, cenx = frame_center(array)
    else:
        cenx, ceny = xy
    array_view = get_square(array, size, ceny, cenx, force=force,
                            verbose=verbose)
    if verbose:
        print(f"New shape: {tuple(array_view.shape)}")
    return array_view


def frame_pad(array, fac, fillwith=0, loc=0, scale=1, keep_parity=True,
              full_output=False, *, generator=None):
    """Pad a frame to ``fac`` times its size (a scalar or (y, x) factors,
    the parity kept unless ``keep_parity`` is False) with ``fillwith``,
    or with Gaussian noise of mean ``loc`` and deviation ``scale`` for
    "noise", drawn from ``generator`` (a ``torch.Generator`` on the
    frame's device; the default generator when None) (vip_tpu
    cosmetics.py:83). With ``full_output`` also the (y0, y1, x0, x1) the
    frame went to."""
    array = as_tensor(array)
    if array.ndim != 2:
        raise TypeError("The input array must be 2d")
    if np.isscalar(fac):
        if fac < 1:
            raise ValueError("fac should be larger than 1")
        fac = [fac, fac]
    elif fac[0] < 1 or fac[-1] < 1:
        raise ValueError("fac elements should be larger than 1")

    y, x = array.shape
    cy_ori, cx_ori = frame_center(array)
    new_y = int(round(y * fac[0]))
    new_x = int(round(x * fac[1]))
    if new_y % 2 != y % 2 and keep_parity:
        new_y -= 1
    if new_x % 2 != x % 2 and keep_parity:
        new_x -= 1
    if isinstance(fillwith, str) and fillwith == "noise":
        dtype = array.dtype if array.is_floating_point() else torch.float64
        array_out = torch.empty((new_y, new_x), dtype=dtype,
                                device=array.device)
        array_out.normal_(loc, scale, generator=generator)
    else:
        array_out = torch.full((new_y, new_x), fillwith, dtype=array.dtype,
                               device=array.device)
    cy, cx = frame_center(array_out)
    y0 = int(cy - cy_ori)
    y1 = int(cy + cy_ori)
    if y1 - y0 < y:
        y1 += 1
    elif y1 - y0 > y:
        y1 -= 1
    x0 = int(cx - cx_ori)
    x1 = int(cx + cx_ori)
    if x1 - x0 < x:
        x1 += 1
    elif x1 - x0 > x:
        x1 -= 1
    array_out[y0:y1, x0:x1] = array
    if full_output:
        return array_out, (y0, y1, x0, x1)
    return array_out


def cube_drop_frames(array, n, m, parallactic=None, verbose=True):
    """Keep frames ``n`` to ``m`` (1-based, inclusive) of a 3d cube, or of
    each channel of a 4d one, and of ``parallactic`` (vip_tpu
    cosmetics.py:130). Returns a tensor copy, and the host angles."""
    array = as_tensor(array)
    if m > array.shape[0]:
        raise TypeError("End index must be smaller than the # of frames")
    if array.ndim == 3:
        array_view = array[n - 1:m].clone()
    elif array.ndim == 4:
        array_view = array[:, n - 1:m].clone()
    else:
        raise TypeError("only 3d and 4d cubes are supported")
    if parallactic is not None:
        parallactic = np.asarray(parallactic.cpu() if isinstance(
            parallactic, torch.Tensor) else parallactic)
        if parallactic.ndim != 1:
            raise TypeError("Parallactic angles vector has wrong shape")
        parallactic = parallactic[n - 1:m]
    if verbose:
        print(f"Cube successfully sliced. New cube shape: "
              f"{tuple(array_view.shape)}")
    if parallactic is not None:
        return array_view, parallactic
    return array_view


def frame_remove_stripes(array):
    """Subtract from each column the mean of its first and last 50 rows
    (vip_tpu cosmetics.py:154; VIP changes its input in place, vip_tpu and
    the port return a new frame)."""
    array = as_tensor(array)
    if not array.is_floating_point():
        array = array.to(torch.float64)
    lines = torch.cat((array[:50], array[-50:]))
    return array - lines.mean(dim=0)[None, :]


def _correct_nan_frames(frames, half_res_y):
    """NaN correction of a batch (B, y, x): every NaN pixel by the median
    of its good 3x3 neighbours, sweep after sweep, all frames in one
    batched sigma filter; with ``half_res_y`` on every other row, then
    each row repeated. Returns the frames, their NaN counts and their
    sweep counts."""
    from ..ops.badpix import cube_sigma_filter_device
    from ..stats.clip_sigma import sigma_filter

    if not frames.is_floating_point():
        frames = frames.to(torch.float64)
    n_y = frames.shape[-2]
    if half_res_y:
        if n_y % 2 != 0:
            raise ValueError("The input frames do not have an even number "
                             "of rows. Hence, you should probably not be "
                             "using the option half_res_y = True.")
        frames = frames[:, ::2]
    nan_map = torch.isnan(frames)
    nnan = nan_map.sum(dim=(1, 2))
    if min(frames.shape[-2:]) < 3:
        # frames smaller than the window take vip_tpu's host route
        out = torch.stack([sigma_filter(f, b) for f, b in
                           zip(frames, nan_map)])
        nits = torch.zeros_like(nnan)
    else:
        out, nits = cube_sigma_filter_device(frames, nan_map)
    if half_res_y:
        out = torch.repeat_interleave(out, 2, dim=1)
    return out, nnan, nits


def cube_correct_nan(cube, neighbor_box=3, min_neighbors=3, verbose=False,
                     half_res_y=False, nproc=1):
    """Replace the NaN pixels of a frame or of every frame of a 3d/4d cube
    by the median of their good neighbours, with the iterative sigma
    filter (vip_tpu cosmetics.py:164; as there, the window is 3x3 with 3
    good neighbours whatever is passed). Every frame in one batched call
    on the cube's device; ``nproc`` changes nothing. Returns a tensor."""
    cube = as_tensor(cube)
    if cube.ndim not in (2, 3, 4):
        return cube.clone()
    out, _, _ = _correct_nan_frames(cube.reshape(-1, *cube.shape[-2:]),
                                    half_res_y)
    out = out.reshape(cube.shape)
    if verbose and cube.ndim > 2:
        print("All nan pixels are corrected.")
    return out


def nan_corr_2d(obj_tmp, neighbor_box, min_neighbors, half_res_y, verbose,
                full_output=True):
    """Correct the NaN pixels of one frame with the iterative sigma filter
    (vip_tpu cosmetics.py:253), on every other row with ``half_res_y``,
    each row then repeated. Returns the frame (a tensor) and, with
    ``full_output``, its number of NaN pixels (counted on the rows it
    used)."""
    out, nnan, nits = _correct_nan_frames(as_tensor(obj_tmp)[None],
                                          half_res_y)
    if verbose:
        print("Required number of iterations in the sigma filter: ",
              int(nits[0]))
    if full_output:
        return out[0], int(nnan[0])
    return out[0]


def approx_stellar_position(cube, fwhm, return_test=False, verbose=False):
    """Approximate star position in each channel of a cube (vip_tpu
    cosmetics.py:190): the peak of each median-filtered frame, outliers
    beyond 3 sigma of the 2.5-sigma-clipped median replaced by the nearest
    good channels. Host ints in a float (channels, 2) array, as vip_tpu;
    with ``return_test`` also which channels passed."""
    from ..metrics.detection import _sigma_clipped_stats, peak_coordinates

    obj_tmp = cube.detach().cpu().numpy() if isinstance(cube, torch.Tensor) \
        else np.asarray(cube)
    n_z = obj_tmp.shape[0]
    if np.isscalar(fwhm):
        fwhm = np.full(n_z, fwhm)

    star_tmp_idx = np.zeros([n_z, 2])
    star_approx_idx = np.zeros([n_z, 2])
    test_result = np.ones(n_z)
    for zz in range(n_z):
        star_tmp_idx[zz] = peak_coordinates(obj_tmp[zz], fwhm[zz])

    _, med_y, stddev_y = _sigma_clipped_stats(star_tmp_idx[:, 0], sigma=2.5)
    _, med_x, stddev_x = _sigma_clipped_stats(star_tmp_idx[:, 1], sigma=2.5)
    lim_inf_y, lim_sup_y = med_y - 3 * stddev_y, med_y + 3 * stddev_y
    lim_inf_x, lim_sup_x = med_x - 3 * stddev_x, med_x + 3 * stddev_x
    if verbose:
        print("median y of star - 3sigma = ", lim_inf_y)
        print("median y of star + 3sigma = ", lim_sup_y)
        print("median x of star - 3sigma = ", lim_inf_x)
        print("median x of star + 3sigma = ", lim_sup_x)

    for zz in range(n_z):
        if (star_tmp_idx[zz, 0] < lim_inf_y
                or star_tmp_idx[zz, 0] > lim_sup_y
                or star_tmp_idx[zz, 1] < lim_inf_x
                or star_tmp_idx[zz, 1] > lim_sup_x):
            test_result[zz] = 0

    # an outlier takes the mean of the nearest good channels
    for zz in range(n_z):
        if test_result[zz] == 0:
            ii = 1
            inf_neigh = max(0, zz - ii)
            sup_neigh = min(n_z - 1, zz + ii)
            while test_result[inf_neigh] == 0 \
                    and test_result[sup_neigh] == 0:
                ii += 1
                inf_neigh = max(0, zz - ii)
                sup_neigh = min(n_z - 1, zz + ii)
            if test_result[inf_neigh] == 1 and test_result[sup_neigh] == 1:
                star_approx_idx[zz] = np.floor(
                    (star_tmp_idx[sup_neigh] + star_tmp_idx[inf_neigh]) / 2)
            elif test_result[inf_neigh] == 1:
                star_approx_idx[zz] = star_tmp_idx[inf_neigh]
            else:
                star_approx_idx[zz] = star_tmp_idx[sup_neigh]
        else:
            star_approx_idx[zz] = star_tmp_idx[zz]

    if return_test:
        return star_approx_idx, test_result.astype(bool)
    return star_approx_idx

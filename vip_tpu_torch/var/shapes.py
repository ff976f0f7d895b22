"""Masks, annulus segments, ellipses, squares and cube→matrix conversion
(port of ``vip_tpu.var.shapes``).

The pixel selections (strict ``< 1`` normalized distance, skimage.draw
semantics; annulus segments; ellipses) are built on the host as static
geometry and applied to the tensor on its own device. The spider mask's
polygons take an even-odd crossing test on tensors (``_polygon_coords``)
in place of vip_tpu's ``matplotlib.path.Path.contains_points``: the
card's machine has no matplotlib.
"""

import functools

import numpy as np
import torch

from ..config.device import as_tensor, get_device, work_dtype
from ..config.utils_conf import frame_or_shape
from ..ops.linalg import matrix_scaling_jax
from .coords import dist, frame_center

__all__ = ["mask_circle", "get_annulus_segments", "matrix_scaling",
           "prepare_matrix", "reshape_matrix", "resolve_n_segments",
           "disk_coords", "get_square", "get_circle", "get_annular_wedge",
           "mask_ellipse", "get_ellipse", "get_ell_annulus",
           "create_ringed_spider_mask", "mask_roi"]


def _disk(shape, cy, cx, radius):
    """Boolean (y, x) map of the pixels strictly inside a circle
    (skimage.draw.disk semantics, vip_tpu shapes.py:40-52)."""
    yy, xx = np.ogrid[0:float(shape[0]), 0:float(shape[1])]
    return ((yy - cy) / radius) ** 2 + ((xx - cx) / radius) ** 2 < 1


def disk_coords(center, radius, shape):
    """Host (yy, xx) index arrays of the pixels strictly inside a circle
    (skimage.draw.disk semantics; vip_tpu shapes.py:49)."""
    return np.nonzero(_disk(shape, center[0], center[1], radius))


def get_square(array, size, y, x, position=False, force=False, verbose=True):
    """Square subframe of ``size`` px centered at (y, x) (vip_tpu
    shapes.py:186): unless ``force``, the size takes the parity of the
    frame. A numpy frame gives a numpy copy, a tensor a tensor copy; with
    ``position`` also the (y0, x0) of its corner."""
    size_init_y, size_init_x = array.shape[-2:]
    size_init = array.shape[0]
    if array.ndim != 2:
        raise TypeError("Input array is not a 2d array.")
    if not isinstance(size, (int, np.integer)):
        raise TypeError("`Size` must be integer")
    if size >= size_init_y and size >= size_init_x:
        raise ValueError("`Size` is equal to or bigger than the initial frame"
                         " size")
    if not force:
        if size_init % 2 == 0 and size % 2 != 0:
            size += 1
            if verbose:
                print("`Size` is odd (while input frame size is even). "
                      f"Setting `size` to {size} pixels")
        elif size_init % 2 != 0 and size % 2 == 0:
            size += 1
            if verbose:
                print("`Size` is even (while input frame size is odd). "
                      f"Setting `size` to {size} pixels")

    wing = (size - 1) / 2
    y0 = int(y - wing)
    y1 = int(y + wing + 1)
    x0 = int(x - wing)
    x1 = int(x + wing + 1)
    if y0 < 0 or x0 < 0 or y1 > size_init_y or x1 > size_init_x:
        raise RuntimeError(
            f"square cannot be obtained with size={size}, y={y}, x={x}")
    sub = array[y0:y1, x0:x1]
    sub = sub.clone() if isinstance(sub, torch.Tensor) else np.array(sub)
    if position:
        return sub, y0, x0
    return sub


def mask_circle(array, radius, fillwith=0, mode="in", cy=None, cx=None,
                output="masked_arr"):
    """Mask the pixels inside (``mode="in"``) or outside (``"out"``) a
    circle of a 2d/3d/4d tensor (vip_tpu shapes.py:55). ``output=
    "bool_mask"`` returns the (y, x) bool tensor that is False inside."""
    if not isinstance(fillwith, (int, float)):
        raise ValueError("`fillwith` must be integer, float or np.nan")
    array = as_tensor(array)
    if cy is None or cx is None:
        cy, cx = frame_center(array)
    shape = tuple(array.shape[-2:])

    if radius == 0:
        keep = mode == "in"
        if output == "bool_mask":
            return torch.full(shape, keep, dtype=torch.bool,
                              device=array.device)
        return array.clone() if keep else torch.zeros_like(array)

    inside = torch.as_tensor(_disk(shape, cy, cx, radius),
                             device=array.device)
    if output == "bool_mask":
        return ~inside
    if mode == "in":
        return array.masked_fill(inside, fillwith)
    elif mode == "out":
        return array.masked_fill(~inside, fillwith)
    raise ValueError("mode not recognized")


def get_circle(array, radius, cy=None, cx=None, mode="mask"):
    """The pixels of a 2d frame strictly inside ``(y - cy)² + (x - cx)² <
    radius²`` (vip_tpu shapes.py:229; a stricter test than
    ``mask_circle``'s). 'mask' zeroes the rest, 'val' returns the values
    inside, 'ind' their host (yy, xx). A tensor stays a tensor on its own
    device, numpy stays numpy."""
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array.")
    sy, sx = array.shape
    if cy is None or cx is None:
        cy, cx = frame_center(array, verbose=False)
    yy, xx = np.ogrid[:sy, :sx]
    circle = (yy - cy) ** 2 + (xx - cx) ** 2 < radius ** 2
    if mode == "ind":
        return np.where(circle)
    if isinstance(array, torch.Tensor):
        circle = torch.as_tensor(circle, device=array.device)
    else:
        array = np.asarray(array)
    if mode == "mask":
        return array * circle
    if mode == "val":
        return array[circle]
    raise ValueError(f"mode '{mode}' unknown!")


@functools.lru_cache(maxsize=8)
def _polar_grid(shape, cy, cx):
    """(radius, azimuth in [0, 2π)) of every pixel of a frame of ``shape``
    about (cy, cx), read-only: annular callers ask for one per annulus."""
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    rad = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    phirot = np.arctan2(yy - cy, xx - cx) % (2 * np.pi)
    rad.flags.writeable = phirot.flags.writeable = False
    return rad, phirot


def get_annulus_segments(data, inner_radius, width, nsegm=1, theta_init=0,
                         optim_scale_fact=1, mode="ind", out=False):
    """Indices, values or masks of the segments of a centered annulus
    (vip_tpu shapes.py:278): the annulus is ``inner <= r < inner +
    width*optim_scale_fact``, the segments tile the azimuth from
    ``theta_init`` degrees off the positive x-axis, counter-clockwise;
    ``out=True`` takes the complement of each segment.

    ``data`` is a 2-d frame (numpy or tensor) or a shape tuple. Mode 'ind'
    returns host ``(yy, xx)`` index arrays, as ``np.where``; 'val' and
    'mask' apply the segments to ``data`` on its own device.
    """
    if isinstance(data, tuple):
        shape = data
    else:
        if data.ndim != 2:
            raise TypeError("`data` must be a frame or a shape tuple")
        shape = tuple(data.shape)
    if not isinstance(nsegm, int):
        raise TypeError("`nsegm` must be an integer")

    cy, cx = frame_center(shape)
    azimuth_coverage = np.deg2rad(int(np.ceil(360 / nsegm)))
    twopi = 2 * np.pi

    rad, phirot = _polar_grid(shape, cy, cx)
    outer_radius = inner_radius + (width * optim_scale_fact)
    ring = (rad >= inner_radius) & (rad < outer_radius)
    masks = []
    for i in range(nsegm):
        phi_start = np.deg2rad(theta_init) + (i * azimuth_coverage)
        phi_end = phi_start + azimuth_coverage
        if phi_start < twopi and phi_end > twopi:
            masks.append(ring & (phirot >= phi_start) & (phirot <= twopi)
                         | ring & (phirot >= 0)
                         & (phirot < phi_end - twopi))
        elif phi_start >= twopi and phi_end > twopi:
            masks.append(ring & (phirot >= phi_start - twopi)
                         & (phirot < phi_end - twopi))
        else:
            masks.append(ring & (phirot >= phi_start) & (phirot < phi_end))
    if out:
        masks = ~np.array(masks)

    if mode == "ind":
        return [np.where(mask) for mask in masks]
    if mode not in ("val", "mask"):
        raise ValueError(f"mode '{mode}' unknown!")
    array = as_tensor(np.zeros(shape) if isinstance(data, tuple) else data)
    masks = [torch.as_tensor(mask, device=array.device) for mask in masks]
    if mode == "val":
        return [array[mask] for mask in masks]
    return [array * mask for mask in masks]


def resolve_n_segments(n_segments, n_annuli, asize, default=1):
    """Per-annulus segment counts (vip_tpu shapes.py:524): an int
    broadcasts; 'auto' keeps each segment's arc close to one 4-segment arc
    of the first annuli."""
    if n_segments is None:
        return [default] * n_annuli
    if isinstance(n_segments, int):
        return [n_segments] * n_annuli
    if n_segments == "auto":
        counts = [2, 3]
        arc = 2 * np.tan(360 / 4 / 2) * asize
        for ann in range(2, n_annuli):
            opening = np.rad2deg(2 * np.arctan(arc / (2 * ann * asize)))
            counts.append(int(np.ceil(360 / opening)))
        return counts
    return list(n_segments)


def matrix_scaling(matrix, scaling):
    """Scale a matrix (sklearn.preprocessing.scale semantics; vip_tpu
    shapes.py:432)."""
    return matrix_scaling_jax(as_tensor(matrix), scaling)


def prepare_matrix(array, scaling=None, mask_center_px=None, mode="fullfr",
                   inner_radius=None, outer_radius=None,
                   discard_mask_pix=False, verbose=True):
    """Build the [n_frames, n_px] matrix for SVD/PCA (vip_tpu
    shapes.py:458). 'fullfr' returns the matrix; 'annular' the matrix of
    the pixels of the centered annulus [inner_radius, outer_radius) and
    their host (yy, xx) indices."""
    array = as_tensor(array)
    if mode == "annular":
        if inner_radius is None or outer_radius is None:
            raise ValueError("`inner_radius` and `outer_radius` must be "
                             "defined in annular mode")
        fr_size = array.shape[1]
        annulus_width = int(np.round(outer_radius - inner_radius))
        ind = get_annulus_segments((fr_size, fr_size), inner_radius,
                                   annulus_width, nsegm=1)[0]
        yy, xx = (torch.as_tensor(i, device=array.device) for i in ind)
        matrix = matrix_scaling_jax(array[:, yy, xx], scaling)
        if verbose:
            print("Done vectorizing the cube annulus. Matrix shape: "
                  f"({matrix.shape[0]}, {matrix.shape[1]})")
        return matrix, ind
    if mode != "fullfr":
        raise ValueError("mode not recognized")
    if mask_center_px:
        if discard_mask_pix:
            keep = mask_circle(array, mask_center_px, output="bool_mask")
            array = array[:, keep]
        else:
            array = mask_circle(array, mask_center_px)
    matrix = matrix_scaling_jax(array.reshape(array.shape[0], -1), scaling)
    if verbose:
        print("Done vectorizing the frames. Matrix shape: "
              f"({matrix.shape[0]}, {matrix.shape[1]})")
    return matrix


def reshape_matrix(array, y, x):
    """Matrix of vectorized frames → cube (vip_tpu shapes.py:497)."""
    return as_tensor(array).reshape(array.shape[0], y, x)


def get_annular_wedge(data, inner_radius, width, wedge=(0, 360), mode="ind"):
    """Indices, values or mask of the wedge ``wedge`` = (start, end)
    degrees (counter-clockwise from the positive x-axis, the end may pass
    360) of the annulus ``inner <= r < inner + width`` (vip_tpu
    shapes.py:338). ``data`` is a 2-d frame or a shape tuple; mode 'ind'
    returns host ``(yy, xx)`` index arrays, as ``np.where``; 'val' and
    'mask' apply the wedge to a frame on its own device."""
    shape = data if isinstance(data, tuple) else tuple(data.shape)
    cy, cx = frame_center(shape)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    rad = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    phirot = np.arctan2(yy - cy, xx - cx) % (2 * np.pi)
    ring = (rad >= inner_radius) & (rad < inner_radius + width)
    phi_start = np.deg2rad(wedge[0])
    phi_end = np.deg2rad(wedge[1])
    if phi_start < 2 * np.pi and phi_end > 2 * np.pi:
        mask = ring & (((phirot >= phi_start) & (phirot <= 2 * np.pi))
                       | ((phirot >= 0) & (phirot < phi_end - 2 * np.pi)))
    elif phi_start >= 2 * np.pi and phi_end > 2 * np.pi:
        mask = ring & (phirot >= phi_start - 2 * np.pi) \
            & (phirot < phi_end - 2 * np.pi)
    else:
        mask = ring & (phirot >= phi_start) & (phirot < phi_end)

    if mode == "ind":
        return np.where(mask)
    if mode not in ("val", "mask"):
        raise ValueError(f"mode '{mode}' unknown!")
    array = as_tensor(data)
    m = torch.as_tensor(mask, device=array.device)
    return array[m] if mode == "val" else array * m


def _select(array, mask, mode):
    """Apply a host bool mask in one of the region modes: 'ind' host
    indices, 'val' the values inside, 'mask' the array zeroed outside,
    'bool' the mask itself. A tensor stays a tensor on its own device,
    numpy stays numpy."""
    if mode == "ind":
        return np.where(mask)
    if mode == "bool":
        return mask
    if mode not in ("val", "mask"):
        raise ValueError(f"mode '{mode}' unknown!")
    if isinstance(array, torch.Tensor):
        mask = torch.as_tensor(mask, device=array.device)
    return array[mask] if mode == "val" else array * mask


def mask_ellipse(array, a, b, theta, fillwith=0, mode="in", cy=None, cx=None,
                 output="masked_arr"):
    """Mask the pixels inside (``mode="in"``) or outside (``"out"``) an
    ellipse of semi-axes ``a`` (along x at ``theta`` = 90) and ``b``,
    ``theta`` in degrees, of a 2d/3d/4d tensor (vip_tpu shapes.py:100).
    ``output="bool_mask"`` returns the (y, x) bool tensor that is False
    inside."""
    array = as_tensor(array)
    if cy is None or cx is None:
        cy, cx = frame_center(array)
    shape = tuple(array.shape[-2:])
    rot = -np.deg2rad(theta - 90)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    dy = yy - cy
    dx = xx - cx
    yr = dy * np.cos(rot) + dx * np.sin(rot)
    xr = -dy * np.sin(rot) + dx * np.cos(rot)
    inside = torch.as_tensor((yr / b) ** 2 + (xr / a) ** 2 < 1,
                             device=array.device)
    if output == "bool_mask":
        return ~inside
    if mode == "in":
        return array.masked_fill(inside, fillwith)
    elif mode == "out":
        return torch.where(inside, array, torch.full_like(array, fillwith))
    raise ValueError("mode not recognized")


def get_ellipse(data, a, b, pa, cy=None, cx=None, mode="ind"):
    """The pixels strictly inside an ellipse of semi-axes ``a`` ≥ ``b``
    whose major axis is at ``pa`` degrees from +y, by the two-foci test
    (vip_tpu shapes.py:250). ``data`` is a 2d frame or a shape tuple;
    modes 'ind', 'val', 'mask', 'bool' as :func:`_select`."""
    array = frame_or_shape(data)
    if cy is None or cx is None:
        cy, cx = frame_center(array, verbose=False)
    f = np.sqrt(a ** 2 - b ** 2)
    pa_rad = np.deg2rad(pa)
    pos_f1 = (cy + f * np.cos(pa_rad), cx + f * np.sin(pa_rad))
    pos_f2 = (cy - f * np.cos(pa_rad), cx - f * np.sin(pa_rad))
    yy, xx = np.ogrid[: array.shape[0], : array.shape[1]]
    ell = (np.sqrt((yy - pos_f1[0]) ** 2 + (xx - pos_f1[1]) ** 2)
           + np.sqrt((yy - pos_f2[0]) ** 2 + (xx - pos_f2[1]) ** 2))
    return _select(array, ell < 2 * a, mode)


def get_ell_annulus(data, a, b, PA, width, cy=None, cx=None, mode="ind"):
    """An elliptical annulus of ``width`` px around the ellipse (a, b, PA):
    the ellipse grown by width/2 along a (and b·width/a along b) without
    the one shrunk as much (vip_tpu shapes.py:502)."""
    array = frame_or_shape(data)
    hwa = width / 2
    hwb = (width * b / a) / 2
    big = get_ellipse(array, a + hwa, b + hwb, PA, cy=cy, cx=cx, mode="bool")
    small = get_ellipse(array, a - hwa, b - hwb, PA, cy=cy, cx=cx,
                        mode="bool")
    return _select(array, big ^ small, mode)


def _ellipse_in_shape(shape, center, radii):
    r_lim, c_lim = np.ogrid[0:float(shape[0]), 0:float(shape[1])]
    distances = ((r_lim - center[0]) / radii[0]) ** 2 \
        + ((c_lim - center[1]) / radii[1]) ** 2
    return np.nonzero(distances < 1)


def _unbounded_disk(center, radius):
    """Host (rr, cc) of the disk of ``radius`` about ``center`` on a canvas
    large enough to hold it (vip_tpu shapes.py:168)."""
    cy, cx = center
    size = int(np.ceil(max(cy, cx) + radius + 2))
    return _ellipse_in_shape((size, size), center, (radius, radius))


def _polygon_coords(r, c, shape):
    """Host (rr, cc) of the pixels of ``shape`` inside the closed polygon
    of vertices (r, c), as ``matplotlib.path.Path(...).contains_points``
    with radius 0 selects them (vip_tpu shapes.py:175): the even-odd
    crossing test of matplotlib's ``point_in_path``, with its float64
    expressions, evaluated for all pixels at once on
    :func:`~vip_tpu_torch.get_device`. A pixel on an edge goes where
    those expressions put it."""
    dev = get_device()
    vr = np.asarray(r, dtype=float)
    vc = np.asarray(c, dtype=float)
    tx = torch.arange(shape[0], dtype=torch.float64, device=dev)[:, None]
    ty = torch.arange(shape[1], dtype=torch.float64, device=dev)[None, :]
    inside = torch.zeros(shape, dtype=torch.bool, device=dev)
    if vr.size < 3:
        return np.nonzero(inside.cpu().numpy())
    # the path's first vertex (x, y) = (row, col); the last edge closes it
    yflag0 = vc[0] >= ty
    for i in range(vr.size):
        x0, y0 = vr[i], vc[i]
        x1, y1 = vr[(i + 1) % vr.size], vc[(i + 1) % vr.size]
        yflag1 = y1 >= ty
        cross = ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1
        inside ^= (yflag0 != yflag1) & cross
        yflag0 = yflag1
    return np.nonzero(inside.cpu().numpy())


def create_ringed_spider_mask(im_shape, ann_out, ann_in=0, sp_width=10,
                              sp_angle=0, nlegs=6):
    """Mask of an annulus (``ann_in`` ≤ r < ``ann_out``) with ``nlegs``
    spider legs of ``sp_width`` px at ``sp_angle`` degrees zeroed (one
    angle: the legs evenly spaced; a list: one a branch), 1 inside, 0
    elsewhere (vip_tpu shapes.py:134). A tensor on
    :func:`~vip_tpu_torch.get_device`."""
    mask = np.zeros(im_shape)
    nbranch = int(nlegs / 2)
    s = im_shape
    r = min(s) / 2
    theta = np.arctan2(sp_width / 2, r)

    cy, cx = frame_center(mask)
    rr0, cc0 = _unbounded_disk((cy, cx), ann_out)
    cond = (rr0 >= 0) & (rr0 < s[0]) & (cc0 >= 0) & (cc0 < s[1])
    mask[rr0[cond], cc0[cond]] = 1

    t0 = np.array([theta, np.pi - theta, np.pi + theta, 2 * np.pi - theta])
    if isinstance(sp_angle, (list, np.ndarray)):
        dtheta = [sp_angle[i] - sp_angle[0] for i in range(nbranch)]
    else:
        sp_angle = [sp_angle]
        dtheta = [i * 180.0 / nbranch for i in range(nbranch)]
    for i in range(nbranch):
        tn = t0 + np.deg2rad(sp_angle[0] + dtheta[i])
        xn = r * np.cos(tn) + s[1] / 2
        yn = r * np.sin(tn) + s[0] / 2
        rr, cc = _polygon_coords(yn, xn, s)
        mask[rr, cc] = 0
    if ann_in > 0:
        mask[disk_coords((cy, cx), ann_in, s)] = 0
    dev = get_device()
    return torch.as_tensor(mask, dtype=work_dtype(np.float64, dev),
                           device=dev)


def mask_roi(array, source_xy, exc_radius=4, ann_width=4, inc_radius=8,
             mode="val", plot=False):
    """Region of interest of a test point source at ``source_xy`` (x, y)
    [GEB20]: the circle of ``inc_radius`` at the source, the same circle
    opposite the star, and the annulus of ``ann_width`` through the
    source, the circle of ``exc_radius`` at the source removed from the
    first and the last (vip_tpu shapes.py:372). As vip_tpu, the mask is
    built from the masked values, so zero pixels drop out of it, and
    'ind' returns the mask's indices (the reference's are always empty).
    Modes 'val', 'mask', 'bool', 'ind'; ``plot`` draws the mask
    (matplotlib, imported only then)."""
    if exc_radius >= inc_radius:
        print("Warning: The excluded region is bigger than the included "
              "region")
    host = array.detach().cpu().numpy() if isinstance(array, torch.Tensor) \
        else np.asarray(array)
    frsize = host.shape[0]
    cx, cy = source_xy
    yc, xc = frame_center(host)
    distance = dist(yc, xc, cy, cx)
    if distance >= (frsize / 2) - (inc_radius / 2):
        raise TypeError("Circles are out of the field. Try changing "
                        "coordinates or the circles radius")
    if ann_width / 2 + distance > frsize / 2:
        raise TypeError("Annulus is out of the field. Try changing "
                        "coordinates or the annulus width")

    yr1, xr1 = get_circle(host, radius=exc_radius, cy=cy, cx=cx, mode="ind")
    r2 = get_circle(host, radius=inc_radius, cy=cy, cx=cx, mode="mask")
    r3 = get_circle(host, radius=inc_radius, cy=2 * yc - cy,
                    cx=2 * xc - cx, mode="mask")
    r4 = np.zeros_like(host)
    ind = get_annulus_segments(host, distance - ann_width / 2, ann_width)[0]
    r4[ind] = host[ind]
    r2[yr1, xr1] = 0
    r4[yr1, xr1] = 0
    mask = (r2 + r3 + r4) != 0
    if plot:
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(figsize=(5, 5), dpi=100)
        ax.imshow(mask, origin="lower", interpolation="nearest",
                  cmap="viridis")
        ax.plot(xc, yc, "r+", ms=10)
        plt.show()
    if mode not in ("bool", "val", "mask", "ind"):
        raise ValueError(f"mode '{mode}' unknown!")
    return _select(array, mask, mode)

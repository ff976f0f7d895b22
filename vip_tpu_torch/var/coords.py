"""Image-coordinate conventions and polar conversions (port of
``vip_tpu.var.coords``).

The load-bearing convention is ``frame_center``: odd dims → (dim-1)/2,
even dims → dim/2, i.e. for even frames the center sits on the top-right
pixel of the central 2x2 block. Every FFT rotation in the port assumes it.
"""

import numpy as np

__all__ = ["dist", "dist_matrix", "frame_center", "cart_to_pol",
           "pol_to_cart"]


def dist(yc, xc, y1, x1):
    """Euclidean distance between two points (or arrays of points)."""
    return np.hypot(yc - y1, xc - x1)


def dist_matrix(n, cx=None, cy=None):
    """Host matrix of the Euclidean distances of the pixels of an n x n
    frame (or of ``n``'s first two axes when it is an array) from (cx,
    cy), the geometric center by default (vip_tpu coords.py:28)."""
    if isinstance(n, (int, np.integer)):
        n1 = n2 = int(n)
    else:
        n1, n2 = n.shape[:2]
    if cy is None:
        cy = (n1 - 1) / 2
    if cx is None:
        cx = (n2 - 1) / 2
    yy, xx = np.ogrid[:n1, :n2]
    return np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)


def frame_center(array, verbose=False):
    """Integer (cy, cx) of the frame center of a 2d/3d/4d array or tensor
    (the trailing two axes are the image), or of a shape tuple."""
    if hasattr(array, "ndim"):
        if array.ndim not in (2, 3, 4):
            raise ValueError("`array` is not a 2d, 3d or 4d array")
        shape = tuple(array.shape[-2:])
    else:
        shape = tuple(array)
    cy = shape[0] / 2
    cx = shape[1] / 2
    if shape[0] % 2:
        cy -= 0.5
    if shape[1] % 2:
        cx -= 0.5
    if verbose:
        print(f"Center px coordinates at x,y = ({cx}, {cy})")
    return int(cy), int(cx)


def cart_to_pol(x, y, x_err=0, y_err=0, cx=0, cy=0, astro_convention=False):
    """Host cartesian → polar (r, theta in degrees) of points or arrays of
    points, with first-order error propagation when an error is given
    (vip_tpu coords.py:71)."""
    r = dist(cy, cx, y, x)
    theta = np.rad2deg(np.arctan2(y - cy, x - cx))
    if astro_convention:
        theta -= 90

    dx = x - cx
    dy = y - cy
    with np.errstate(divide="ignore", invalid="ignore"):
        r1 = dx * x_err / np.sqrt(dx ** 2 + dy ** 2)
        r2 = dy * y_err / np.sqrt(dx ** 2 + dy ** 2)
        t1 = (1 / (1 + (dy / dx) ** 2)) * (1 / dx) * y_err
        t2 = (1 / (1 + (dy / dx) ** 2)) * (-1) * (dy / dx ** 2) * x_err
    r_err = np.sqrt(r1 ** 2 + r2 ** 2)
    theta_err = np.rad2deg(np.sqrt(t1 ** 2 + t2 ** 2))

    if np.any(x_err != 0) or np.any(y_err != 0):
        return r, theta, r_err, theta_err
    return r, theta


def pol_to_cart(r, theta, r_err=0, theta_err=0, cx=0, cy=0,
                astro_convention=False):
    """Host polar (r, theta in degrees) → cartesian, with first-order
    error propagation when an error is given (vip_tpu coords.py:93)."""
    if astro_convention:
        theta = theta + 90
        sign = -1
    else:
        sign = 1

    theta = np.deg2rad(theta)
    theta_err = np.deg2rad(theta_err)

    x = cx + sign * r * np.cos(theta)
    y = cy + r * np.sin(theta)

    t1x = np.cos(theta) ** 2 * r_err ** 2
    t2x = r ** 2 * np.sin(theta) ** 2 * theta_err ** 2
    t1y = np.sin(theta) ** 2 * r_err ** 2
    t2y = r ** 2 * np.cos(theta) ** 2 * theta_err ** 2
    dx_err = np.sqrt(t1x + t2x)
    dy_err = np.sqrt(t1y + t2y)

    if np.any(r_err != 0) or np.any(theta_err != 0):
        return x, y, dx_err, dy_err
    return x, y

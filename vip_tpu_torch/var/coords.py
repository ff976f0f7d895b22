"""Image-coordinate conventions (port of ``vip_tpu.var.coords``).

The load-bearing convention is ``frame_center``: odd dims → (dim-1)/2,
even dims → dim/2, i.e. for even frames the center sits on the top-right
pixel of the central 2x2 block. Every FFT rotation in the port assumes it.
"""

import numpy as np

__all__ = ["dist", "dist_matrix", "frame_center"]


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

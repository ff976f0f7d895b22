"""Plain reference of the full-frame PCA-ADI of a 3-d cube, as VIP's
``pca(cube, angle_list, ncomp=k, ...)`` defines it: the frames as the
rows of a matrix (no centering, no scaling), minus their projection on the
top k right singular vectors of that matrix, each residual frame turned
by minus its parallactic angle with VIP's exact FFT rotation ('vip-fft'),
then the median over frames. 'eigen' and 'lapack' are two routes to the
same singular vectors: here both are the eigh of the Gram matrix."""

import numpy as np

from yardstick import plain
from yardstick.params import take

DEFAULTS = {"ncomp": 1, "svd_mode": "lapack", "imlib": "vip-fft",
            "collapse": "median"}
ALLOWED = {"svd_mode": ("eigen", "lapack"), "imlib": ("vip-fft",),
           "collapse": ("median",)}


def reduce(cube, angles, kwargs, precision="float64"):
    p = take(kwargs, DEFAULTS, ALLOWED)
    n = cube.shape[0]
    k = min(int(p["ncomp"]), n)
    res = plain.pca_residuals(cube.reshape(n, -1), k, precision)
    der = plain.derotate(res.reshape(cube.shape), np.asarray(angles),
                         precision)
    del res
    return plain.median0(der)

"""Plain reference of VIP's double-pass ADI+mSDI full-frame PCA of a
(channels, frames, y, x) cube, ``pca(cube, angles, scale_list=s,
ncomp=(k_sdi, k_adi), adimsdi="double")`` with VIP's defaults otherwise:
every channel padded by reflection and zoomed by its scale (VIP's
scale_fft, the padded size kept), then for each frame one PCA of its
channels (k_sdi components), the residuals zoomed back by 1/scale and
cropped to the frame size, the channels averaged (collapse_ifs 'mean');
then one PCA of those frames (k_adi components), their derotation
('vip-fft') and their median."""

import numpy as np

from yardstick import plain
from yardstick.params import take

DEFAULTS = {"ncomp": (1, 1), "scale_list": None, "adimsdi": "double",
            "svd_mode": "lapack", "imlib": "vip-fft", "imlib2": "vip-fft",
            "collapse": "median", "collapse_ifs": "mean"}
ALLOWED = {"adimsdi": ("double",), "svd_mode": ("eigen", "lapack"),
           "imlib": ("vip-fft",), "imlib2": ("vip-fft",),
           "collapse": ("median",), "collapse_ifs": ("mean",)}


def reduce(cube, angles, kwargs, precision="float64"):
    p = take(kwargs, DEFAULTS, ALLOWED)
    k_sdi, k_adi = (int(v) for v in p["ncomp"])
    scales = np.asarray(p["scale_list"], dtype=np.float64)
    z, n, y, _ = cube.shape
    resc = plain.rescale_channels(cube, scales, precision)
    Y = resc.shape[-1]
    M = resc.transpose(0, 1).reshape(n, z, Y * Y)
    del resc
    res = plain.pca_residuals(M, min(k_sdi, z), precision)
    del M
    res = res.reshape(n, z, Y, Y).transpose(0, 1)
    frames = plain.unscale_channels(res, scales, y, precision).mean(0)
    del res
    res2 = plain.pca_residuals(frames.reshape(n, -1), min(k_adi, n),
                               precision)
    der = plain.derotate(res2.reshape(n, y, y), np.asarray(angles),
                         precision)
    return plain.median0(der)

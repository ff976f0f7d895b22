"""Plain reference of VIP's single-pass ADI+mSDI full-frame PCA of a
(channels, frames, y, x) cube, ``pca(cube, angles, scale_list=s,
ncomp=k, adimsdi="single")`` with VIP's defaults otherwise: every channel
padded by reflection and zoomed by its scale through its spectrum (VIP's
scale_fft) and cropped back to the frame size, one PCA of all
channel-frames, the residuals zoomed back by 1/scale, the channels
averaged (collapse_ifs 'mean'), the frames derotated ('vip-fft') and
their median taken."""

import numpy as np

from yardstick import plain
from yardstick.params import take

DEFAULTS = {"ncomp": 1, "scale_list": None, "adimsdi": "single",
            "svd_mode": "lapack", "imlib": "vip-fft", "imlib2": "vip-fft",
            "collapse": "median", "collapse_ifs": "mean", "crop_ifs": True}
ALLOWED = {"adimsdi": ("single",), "svd_mode": ("eigen", "lapack"),
           "imlib": ("vip-fft",), "imlib2": ("vip-fft",),
           "collapse": ("median",), "collapse_ifs": ("mean",),
           "crop_ifs": (True,)}


def reduce(cube, angles, kwargs, precision="float64"):
    p = take(kwargs, DEFAULTS, ALLOWED)
    scales = np.asarray(p["scale_list"], dtype=np.float64)
    z, n, y, _ = cube.shape
    big = plain.center_crop(plain.rescale_channels(cube, scales, precision),
                            y)
    M = big.transpose(0, 1).reshape(n * z, y * y)
    del big
    k = min(int(p["ncomp"]), n * z)
    res = plain.pca_residuals(M, k, precision)
    del M
    res = res.reshape(n, z, y, y).transpose(0, 1)
    frames = plain.unscale_channels(res, scales, y, precision).mean(0)
    del res
    der = plain.derotate(frames, np.asarray(angles), precision)
    return plain.median0(der)

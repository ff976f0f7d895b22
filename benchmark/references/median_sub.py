"""Plain reference of VIP's full-frame median-ADI of a 3-d cube,
``median_sub(cube, angle_list, mode="fullfr", imlib="vip-fft")`` with
VIP's defaults otherwise (radius_int 0, collapse 'median', no reference
cube): every frame minus the per-pixel median of the cube over frames
(numpy's median), each residual frame turned by minus its parallactic
angle with VIP's exact FFT rotation ('vip-fft'), then the median over
frames.

The path holds no matrix product, so TF32 would not touch it. In
"tf32" this reference instead rounds every FFT's input to TF32
(``plain._round_tf32``, the real and imaginary parts alike): the
precision below float32 in the rotation's own arithmetic, which is
where float32 loses what it loses here. "float32" and "float64" are the
plain rotation of ``plain.derotate``.
"""

import math

import numpy as np
import torch

from yardstick import plain
from yardstick.params import take
from yardstick.roofline import vip_fft_canvas

DEFAULTS = {"mode": "fullfr", "radius_int": 0, "imlib": "vip-fft",
            "collapse": "median"}
ALLOWED = {"mode": ("fullfr",), "radius_int": (0,), "imlib": ("vip-fft",),
           "collapse": ("median",)}


def _round(z):
    """A complex64 tensor with both parts rounded to TF32."""
    return torch.complex(plain._round_tf32(z.real.contiguous()),
                         plain._round_tf32(z.imag.contiguous()))


def _shear_tf32(z, c, dim):
    """``plain._shear`` with the input of each FFT rounded to TF32."""
    N = z.shape[-1]
    f = torch.fft.fftfreq(N, dtype=torch.float64, device=z.device)
    q = torch.arange(N, dtype=torch.float64, device=z.device) - N / 2
    ramp = torch.outer(q, f) if dim == 2 else torch.outer(f, q)
    ang = (-2 * math.pi) * c.to(torch.float64)[:, None, None] * ramp
    phase = torch.polar(torch.ones_like(ang), ang).to(z.dtype)
    spec = torch.fft.fft(_round(z), dim=dim) * phase
    return torch.fft.ifft(_round(spec), dim=dim)


def _derotate_tf32(cube, angles, chunk=8):
    """``plain.derotate`` in float32 with every FFT's input rounded to
    TF32."""
    n, y, _ = cube.shape
    N, p0 = vip_fft_canvas(y)
    dev = cube.device
    out = torch.empty((n, y, y), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        part = cube[s:s + chunk].to(torch.float32)
        B = part.shape[0]
        ext = torch.zeros((B, N + 1, N + 1), dtype=torch.float32, device=dev)
        ext[:, p0:p0 + y, p0:p0 + y] = part
        work = torch.empty((B, N, N), dtype=torch.float32, device=dev)
        a = torch.empty(B, dtype=torch.float64)
        b = torch.empty(B, dtype=torch.float64)
        for i, ang in enumerate(-np.asarray(angles[s:s + chunk], float)):
            k, dangle = plain._quadrant(float(ang))
            work[i] = torch.rot90(ext[i], k, dims=(0, 1))[:N, :N]
            rad = math.radians(dangle)
            a[i], b[i] = math.tan(rad / 2), -math.sin(rad)
        del ext
        a, b = a.to(dev), b.to(dev)
        z = _shear_tf32(work.to(torch.complex64), a, dim=2)
        del work
        z = _shear_tf32(z, b, dim=1)
        z = _shear_tf32(z, a, dim=2)
        out[s:s + B] = z.real[:, p0:p0 + y, p0:p0 + y]
    return out


def reduce(cube, angles, kwargs, precision="float64"):
    take(kwargs, DEFAULTS, ALLOWED)
    res = cube.to(plain.real_dtype(precision))
    res = res - plain.median0(res)
    angles = np.asarray(angles, dtype=np.float64)
    if precision == "tf32":
        der = _derotate_tf32(res, angles)
    else:
        der = plain.derotate(res, angles, precision)
    del res
    return plain.median0(der)

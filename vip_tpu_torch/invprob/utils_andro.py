"""Utilities of ANDROMEDA (port of ``vip_tpu.invprob.utils_andro``, itself
after VIP's port of the LibAndromeda IDL routines).

The shifts and the robust fits work on tensors on their own device and
batch over leading axes: ``calc_psf_shift_subpix`` builds the whole
(precision+1)² bank of sub-pixel shifted PSFs from one FFT of the PSF and
one batched inverse FFT, and ``fitaffine`` fits every row of a batch at
once (each row runs its own bracketing and bisection, masked where it has
converged), so that ANDROMEDA's L1 optimization fits all frame pairs of
an annulus together.
"""

import math

import numpy as np
import torch

from ..config.device import as_tensor

__all__ = []


def _median(x):
    """numpy's median of the last axis: the middle value, or the mean of
    the two middle values of an even count (torch's ``median`` takes the
    lower one)."""
    s = torch.sort(x, dim=-1).values
    m = x.shape[-1]
    return (s[..., (m - 1) // 2] + s[..., m // 2]) / 2


def robust_std(x):
    """Robust standard deviation of ``x`` (of the last axis of a tensor):
    its median absolute deviation over 0.6745 (vip_tpu
    utils_andro.py:9). A tensor of the input's device."""
    x = as_tensor(x)
    return _median((x - _median(x)[..., None]).abs()) / 0.6745


def idl_round(x):
    """Round half away from zero, as IDL's ROUND (vip_tpu
    utils_andro.py:17)."""
    if isinstance(x, torch.Tensor):
        return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))
    return np.trunc(x + np.copysign(0.5, x))


def idl_where(array_expression):
    """Flat indices where the expression holds, as IDL's WHERE (an empty
    array if none)."""
    if isinstance(array_expression, torch.Tensor):
        return torch.flatnonzero(array_expression)
    return np.flatnonzero(array_expression)


def rofunc(x, y, b):
    """For the slope ``b``, the intercept ``a`` that solves the L1 normal
    equation (the median of y - b·x) and the sum of x·sign(y - a - b·x)
    over the points off the line by more than 1e-5 relative (vip_tpu
    utils_andro.py:86); over the last axis, ``b`` one value a row.
    Returns (sum, a)."""
    x, y = as_tensor(x), as_tensor(y)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    arr = y - b[..., None] * x
    a = _median(arr)
    d = y - (b[..., None] * x + a[..., None])
    d = torch.where(y != 0, d / torch.where(y != 0, y, 1.0).abs(), d)
    step = torch.where(d.abs() > 1e-5, torch.where(d >= 0, x, -x), 0.0)
    return step.sum(-1), a


def fitaffine(x, y, debug=False):
    """Robust (least absolute deviations) fit of y = b·x + a over the last
    axis, every leading index its own fit (vip_tpu utils_andro.py:26,
    Numerical Recipes' ``medfit``). Returns (b, a), tensors of the leading
    shape (0-d for 1-d input).

    The least-squares line starts each fit. Where its slope error is
    positive and the L1 residual function f(b) = Σ x·sign(y - a(b) - b·x)
    is not already 0, the slope is bracketed by steps of 1.6x outwards
    from 3 σ_b, then bisected until the bracket is narrower than σ_b/100;
    a fit that needs neither keeps the least-squares slope and the
    intercept ``rofunc`` gives it. Each row is updated only while its own
    stage lasts, so the rows come out as the serial fits would."""
    x, y = as_tensor(x), as_tensor(y)
    m = x.shape[-1]
    sx, sy = x.sum(-1), y.sum(-1)
    sxy, sxx = (x * y).sum(-1), (x ** 2).sum(-1)
    delta = m * sxx - sx ** 2
    a_ls = (sxx * sy - sx * sxy) / delta
    b_ls = (m * sxy - sx * sy) / delta
    chisq = ((y - (a_ls[..., None] + b_ls[..., None] * x)) ** 2).sum(-1)
    sigb = torch.sqrt(chisq / delta)

    b = b1 = b_ls
    f1, a = rofunc(x, y, b1)
    fit = (sigb > 0) & (f1 != 0)
    # bracket: from 3 sigma on the side f1 points to, outwards by 1.6x
    b2 = torch.where(f1 > 0, b1 + 3 * sigb, b1 - 3 * sigb)
    f2, a2 = rofunc(x, y, b2)
    a = torch.where(fit, a2, a)
    grow = fit & (f1 * f2 > 0)
    while bool(grow.any()):
        b_new = b2 + 1.6 * (b2 - b1)
        f_new, a_new = rofunc(x, y, b_new)
        b = torch.where(grow, b_new, b)
        b1, f1 = torch.where(grow, b2, b1), torch.where(grow, f2, f1)
        b2, f2 = torch.where(grow, b_new, b2), torch.where(grow, f_new, f2)
        a = torch.where(grow, a_new, a)
        grow = grow & (f1 * f2 > 0)
    # bisect the bracket down to a hundredth of sigma
    tol = 0.01 * sigb
    halve = fit & ((b2 - b1).abs() > tol)
    while bool(halve.any()):
        b_mid = b1 + 0.5 * (b2 - b1)
        f, a_mid = rofunc(x, y, b_mid)
        left = f * f1 >= 0
        b = torch.where(halve, b_mid, b)
        a = torch.where(halve, a_mid, a)
        b1 = torch.where(halve & left, b_mid, b1)
        f1 = torch.where(halve & left, f, f1)
        b2 = torch.where(halve & ~left, b_mid, b2)
        f2 = torch.where(halve & ~left, f, f2)
        halve = halve & ((b2 - b1).abs() > tol)
    if debug:
        print(f"fitaffine: {int(fit.sum())} of {fit.numel()} fits iterated;"
              f" the lines y = a + b x: a {a.tolist()}, b {b.tolist()}")
    return b, a


def _shift_factors(npix, xshift, yshift, cdtype, device):
    """The phase ramps of LibAndromeda's sub-pixel shift of an npix² frame
    by each (xshift, yshift) pair (arrays of one shape), in float64, in
    the unshifted FFT layout; shape (..., npix, npix)."""
    ramp = torch.arange(npix, dtype=torch.float64) - npix / 2
    xs = torch.as_tensor(xshift, dtype=torch.float64)[..., None, None]
    ys = torch.as_tensor(yshift, dtype=torch.float64)[..., None, None]
    tilt = (-2 * math.pi / npix) * (xs * ramp[None, :] + ys * ramp[:, None])
    fact = torch.fft.fftshift(torch.polar(torch.ones_like(tilt), tilt),
                              dim=(-2, -1))
    return fact.to(device=device, dtype=cdtype)


def subpixel_shift(image, xshift, yshift):
    """Fourier sub-pixel shift of a square frame (of the last two axes of
    a tensor) by (xshift, yshift) pixels, cyclic, no pad (vip_tpu
    utils_andro.py:98, LibAndromeda's subpixel_shift.pro). Returns a
    tensor on the image's device."""
    image = as_tensor(image)
    npix = image.shape[-1]
    if npix != image.shape[-2]:
        raise ValueError("`image` must be square")
    spectrum = torch.fft.fft2(image)
    fact = _shift_factors(npix, xshift, yshift, spectrum.dtype, image.device)
    return torch.fft.ifft2(spectrum * fact).real


def calc_psf_shift_subpix(psf, precision):
    """The bank of the PSF shifted by every (j/precision, i/precision)
    pixel, shape (precision+1, precision+1, n, n), [j_row, i_column]
    shifted by decaly = j/precision and decalx = i/precision (vip_tpu
    utils_andro.py:110): one FFT of the PSF and one batched inverse FFT.
    Returns a tensor on the PSF's device."""
    psf = as_tensor(psf)
    n = psf.shape[-1]
    steps = torch.arange(precision + 1, dtype=torch.float64) / precision
    decaly, decalx = torch.meshgrid(steps, steps, indexing="ij")
    spectrum = torch.fft.fft2(psf)
    fact = _shift_factors(n, decalx, decaly, spectrum.dtype, psf.device)
    return torch.fft.ifft2(spectrum * fact).real

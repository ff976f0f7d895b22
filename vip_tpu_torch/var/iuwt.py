"""Isotropic undecimated wavelet transform, à trous, [KEN15]/[DAB15]
(port of ``vip_tpu.var.iuwt``).

The separable B3-spline à-trous pass works on the last two axes of a
tensor, so a cube is decomposed in one batched pass on its device.
vip_tpu's edges reflect through negative-step slices such as
``x[s2-1::-1]``; torch has none, so each is a ``narrow`` then a ``flip``
of the same rows, added in vip_tpu's order. vip_tpu's 'ser' and 'mp'
variants (a single core, a fork pool of row or column slices) are the
same batched computation here; ``mode`` and ``core_count`` change nothing.
Results are tensors on the input's device (numpy input on
:func:`~vip_tpu_torch.get_device`).
"""

import numpy as np
import torch

from ..config.device import as_tensor

__all__ = ["iuwt_decomposition", "iuwt_recomposition"]

_FILTER = (1. / 16) * np.array([1, 4, 6, 4, 1])


def _axis_pass(x, f, s1, s2, dim):
    """One 5-tap pass of dyadic spacing (s1, s2) = (2^scale, 2^(scale+1))
    along ``dim``, the edges reflected as vip_tpu iuwt.py:29-37."""
    n = x.shape[dim]
    tmp = f[2] * x

    def head(t, m):
        return t.narrow(dim, 0, m)

    def tail(t, m):
        return t.narrow(dim, n - m, m)

    if s2 < n:
        tail(tmp, n - s2).add_(f[0] * head(x, n - s2))
    m = min(s2, n)
    head(tmp, m).add_(f[0] * head(x, m).flip(dim))
    if s1 < n:
        tail(tmp, n - s1).add_(f[1] * head(x, n - s1))
    m = min(s1, n)
    head(tmp, m).add_(f[1] * head(x, m).flip(dim))
    if s1 < n:
        head(tmp, n - s1).add_(f[3] * tail(x, n - s1))
    tail(tmp, m).add_(f[3] * tail(x, m).flip(dim))
    if s2 < n:
        head(tmp, n - s2).add_(f[4] * tail(x, n - s2))
    m = min(s2, n)
    tail(tmp, m).add_(f[4] * tail(x, m).flip(dim))
    return tmp


def _a_trous(C0, scale, f=_FILTER):
    """One à-trous smoothing of the frames of C0 (..., y, x) at a dyadic
    scale: the pass along y, then along x (vip_tpu iuwt.py:20)."""
    s1, s2 = 2 ** scale, 2 ** (scale + 1)
    f = [float(v) for v in f]
    return _axis_pass(_axis_pass(C0, f, s1, s2, -2), f, s1, s2, -1)


def _decompose(C0, scale_count, scale_adjust, store_smoothed):
    for i in range(scale_adjust):
        C0 = _a_trous(C0, i)
    details = []
    for i in range(scale_adjust, scale_count):
        C = _a_trous(C0, i)
        details.append(C0 - _a_trous(C, i))
        C0 = C
    details = torch.stack(details, dim=-3)
    return (details, C0) if store_smoothed else details


def _float(in1):
    x = as_tensor(in1)
    return x if x.is_floating_point() else x.to(torch.float64)


def iuwt_decomposition(in1, scale_count, scale_adjust=0, mode="ser",
                       core_count=2, store_smoothed=False):
    """The detail coefficients (scale_count − scale_adjust, y, x) of a
    frame, and the smoothed frame with ``store_smoothed`` (vip_tpu
    iuwt.py:62). A cube gives (frames, scales, y, x)."""
    return _decompose(_float(in1), int(scale_count), int(scale_adjust),
                      bool(store_smoothed))


def iuwt_recomposition(in1, scale_adjust=0, mode="ser", core_count=1,
                       store_on_gpu=False, smoothed_array=None):
    """The frame recomposed from its detail coefficients (scales, y, x),
    on top of ``smoothed_array`` when given (vip_tpu iuwt.py:73)."""
    in1 = _float(in1)
    max_scale = in1.shape[0] + scale_adjust
    if smoothed_array is None:
        recomposition = torch.zeros_like(in1[0])
    else:
        recomposition = as_tensor(smoothed_array, in1.device, in1.dtype)
    for i in range(max_scale - 1, scale_adjust - 1, -1):
        recomposition = _a_trous(recomposition, i) + in1[i - scale_adjust]
    for i in range(scale_adjust - 1, -1, -1):
        recomposition = _a_trous(recomposition, i)
    return recomposition


def iuwt_decomposition_batch(cube, scale_count, scale_adjust=0,
                             store_smoothed=False):
    """The detail coefficients (frames, scales, y, x) of every frame of a
    cube in one batched pass (vip_tpu iuwt.py:90; vip_tpu ignores
    ``store_smoothed`` here, and so does the port)."""
    return _decompose(_float(cube), int(scale_count), int(scale_adjust),
                      False)


def ser_a_trous(C0, filter, scale):
    """One à-trous pass with any 5-tap ``filter`` (vip_tpu iuwt.py:105)."""
    return _a_trous(_float(C0), int(scale), np.asarray(filter, dtype=float))


def ser_iuwt_decomposition(in1, scale_count, scale_adjust, store_smoothed):
    """The 'ser' form of :func:`iuwt_decomposition` (vip_tpu
    iuwt.py:127)."""
    return iuwt_decomposition(in1, scale_count, scale_adjust,
                              store_smoothed=store_smoothed)


def ser_iuwt_recomposition(in1, scale_adjust, smoothed_array):
    """The 'ser' form of :func:`iuwt_recomposition` (vip_tpu
    iuwt.py:137)."""
    return iuwt_recomposition(in1, scale_adjust,
                              smoothed_array=smoothed_array)


def mp_a_trous(C0, wavelet_filter, scale, core_count):
    """The 'mp' form of :func:`ser_a_trous`; ``core_count`` changes nothing
    (vip_tpu iuwt.py:143)."""
    return ser_a_trous(C0, wavelet_filter, scale)


def mp_a_trous_kernel(C0, wavelet_filter, scale, slice_ind, slice_width,
                      r_or_c="row"):
    """One slice of one direction of the à-trous pass, as vip_tpu's fork
    pool splits it (vip_tpu iuwt.py:150): 'row' passes along y and keeps
    rows ``slice_ind·slice_width`` on, 'col' passes along x and keeps
    those columns."""
    f = [float(v) for v in np.asarray(wavelet_filter, dtype=float)]
    s1, s2 = 2 ** scale, 2 ** (scale + 1)
    lo, hi = slice_ind * slice_width, (slice_ind + 1) * slice_width
    if r_or_c == "col":
        return _axis_pass(_float(C0), f, s1, s2, -1)[..., lo:hi]
    return _axis_pass(_float(C0), f, s1, s2, -2)[..., lo:hi, :]


def mp_iuwt_decomposition(in1, scale_count, scale_adjust, store_smoothed,
                          core_count):
    """The 'mp' form of :func:`iuwt_decomposition` (vip_tpu
    iuwt.py:175)."""
    return ser_iuwt_decomposition(in1, scale_count, scale_adjust,
                                  store_smoothed)


def mp_iuwt_recomposition(in1, scale_adjust, core_count, smoothed_array):
    """The 'mp' form of :func:`iuwt_recomposition` (vip_tpu
    iuwt.py:183)."""
    return ser_iuwt_recomposition(in1, scale_adjust, smoothed_array)

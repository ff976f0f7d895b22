"""Temporal collapse of cubes (port of ``vip_tpu.preproc.subsampling``,
``collapse_jax`` and ``cube_collapse``)."""

import torch

from ..config.device import as_tensor
from ..ops.median import nanmedian_axis0, nanmedian_plain, nanmedian_supported

__all__ = ["cube_collapse"]


def collapse_jax(arr, mode="median", n=50, w=None, ax=0):
    """NaN-aware collapse of a tensor along axis ``ax`` (vip_tpu
    subsampling.py:15). 'median' takes CUDA kernel H1 on a 3-D float32
    CUDA tensor along axis 0, the plain median otherwise."""
    if mode == "mean":
        return torch.nanmean(arr, dim=ax)
    elif mode == "median":
        if nanmedian_supported(arr, ax):
            return nanmedian_axis0(arr.contiguous())
        return nanmedian_plain(arr, ax)
    elif mode == "sum":
        return torch.nansum(arr, dim=ax)
    elif mode == "max":
        allnan = torch.isnan(arr).all(dim=ax)
        mx = torch.where(torch.isnan(arr), -torch.inf, arr).amax(dim=ax)
        return torch.where(allnan, torch.nan, mx)
    elif mode == "absmean":
        return torch.nanmean(torch.abs(arr), dim=ax)
    elif mode == "trimmean":
        N = arr.shape[ax]
        k = (N - n) // 2
        if N % 2 != n % 2:
            n = n + 1
        srt = torch.sort(arr, dim=ax).values
        return torch.nanmean(srt.narrow(ax, k, n), dim=ax)
    elif mode == "wmean":
        if w is None:
            raise ValueError("Weights have to be provided for weighted mean"
                             " mode")
        arr = torch.where(torch.isnan(arr), 0.0, arr)
        w = as_tensor(w, arr.device, arr.dtype)
        return torch.tensordot(w, arr, dims=([0], [ax]))
    raise TypeError("mode not recognized")


def cube_collapse(cube, mode="median", n=50, w=None):
    """Collapse a 3d cube to a frame (or a 4d cube to 3d along the
    temporal axis; vip_tpu subsampling.py:52). Returns a tensor on the
    cube's device."""
    arr = as_tensor(cube)
    if arr.ndim == 3:
        ax = 0
    elif arr.ndim == 4:
        ax = 1
    else:
        raise TypeError("The input array is not a cube or 3d array.")
    if mode == "wmean":
        if w is None:
            raise ValueError("Weights have to be provided for weighted mean"
                             " mode")
        if len(w) != cube.shape[ax]:
            raise TypeError("Weights need same length as cube")
    return collapse_jax(arr, mode=mode, n=n, w=w, ax=ax)

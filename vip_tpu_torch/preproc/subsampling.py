"""Temporal collapse and subsampling of cubes (port of
``vip_tpu.preproc.subsampling``).

``cube_subsample`` collapses all its windows of n frames at once: the
'median' of every window is one launch of CUDA kernel H1 on an (n, m·y,
x) view of the m windows, where vip_tpu launches its median once a
window.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..config.timing import leading_frames, traced
from ..ops.median import nanmedian_axis0, nanmedian_plain, nanmedian_supported

__all__ = ["cube_collapse", "cube_subsample", "cube_subsample_trimmean"]


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
        # numpy's slice: a negative k (n over N) starts at the first frame
        sl = (slice(None),) * (ax % arr.ndim) + (slice(k, k + n),)
        return torch.nanmean(srt[sl], dim=ax)
    elif mode == "wmean":
        if w is None:
            raise ValueError("Weights have to be provided for weighted mean"
                             " mode")
        arr = torch.where(torch.isnan(arr), 0.0, arr)
        w = as_tensor(w, arr.device, arr.dtype)
        return torch.tensordot(w, arr, dims=([0], [ax]))
    raise TypeError("mode not recognized")


@traced("collapse.cube_collapse", leading_frames)
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


def _collapse_windows(arr, mode, w, n=50):
    """Collapse (..., m, k, y, x) windows of k frames along their frame
    axis into (..., m, y, x): 'median' as one median over the frame axis
    of a (k, ...·m·y, x) view (one H1 launch on a float32 CUDA tensor),
    the other modes along the axis."""
    if mode != "median":
        return collapse_jax(arr, mode=mode, n=n, w=w, ax=arr.ndim - 3)
    k, y, x = arr.shape[-3:]
    lead = arr.shape[:-3]
    view = torch.movedim(arr, -3, 0).reshape(k, -1, x)
    return collapse_jax(view, mode="median", ax=0).reshape(*lead, y, x)


def cube_subsample(array, n, mode="mean", w=None, parallactic=None,
                   verbose=True):
    """Collapse every ``n`` consecutive frames of a 3d cube (or of each
    channel of a 4d one) with ``mode`` (vip_tpu subsampling.py:76); the
    frames after the last whole window are dropped. Every window in one
    batched collapse on the cube's device (numpy input on
    :func:`~vip_tpu_torch.get_device`): 'median' is one H1 launch. As
    vip_tpu, 'trimmean' keeps ``cube_collapse``'s default n = 50, which
    for windows of fewer frames is their mean. Returns a tensor, and with
    ``parallactic`` also the host mean angle of each window."""
    arr = as_tensor(array)
    if arr.ndim == 3:
        frames_axis = 0
    elif arr.ndim == 4:
        frames_axis = 1
    else:
        raise TypeError("The input array is not a cube or 3d array")
    if mode == "wmean":
        if w is None:
            raise ValueError("Weights have to be provided for weighted mean"
                             " mode")
        if len(w) != n:
            raise TypeError("Weights need same length as cube")
    nfr = arr.shape[frames_axis]
    m, resid = nfr // n, nfr % n
    win = arr.narrow(frames_axis, 0, m * n)
    win = win.reshape(*arr.shape[:frames_axis], m, n, *arr.shape[-2:])
    out = _collapse_windows(win, mode, w)
    if verbose:
        print(f"Cube temporally subsampled by mean of every {n} frames")
        if resid:
            print(f"Initial # of frames and window are not multiples "
                  f"({resid} frames were dropped)")
    if parallactic is not None:
        pa = np.asarray(parallactic.cpu() if isinstance(
            parallactic, torch.Tensor) else parallactic, dtype=float)
        return out, pa[:m * n].reshape(m, n).mean(axis=1)
    return out


def cube_subsample_trimmean(arr, n, m):
    """Trimmed mean (the ``n`` middle values) of every ``m`` consecutive
    frames (vip_tpu subsampling.py:117), the windows in one batched
    collapse on the cube's device. vip_tpu's quirks are kept: its loop
    recomputes the first window on every pass (the same value, computed
    once here), and the extra last frame is the trimmed mean of
    ``arr[-res:]``, the last ``res = frames % m`` frames, which is the
    whole cube when ``res`` is 0. Returns a tensor of frames // m + 1
    frames."""
    cube = as_tensor(arr)
    if cube.ndim != 3:
        raise TypeError("The input array is not a cube or 3d array")
    num, res = cube.shape[0] // m, cube.shape[0] % m
    last = collapse_jax(cube[-res:], mode="trimmean", n=n, ax=0)
    print("Cube temporally subsampled by taking the trimmed mean of every "
          f"{m} frames")
    if num == 0:
        return last[None]
    win = cube[:num * m].reshape(num, m, *cube.shape[1:])
    return torch.cat([_collapse_windows(win, "trimmean", None, n=n),
                      last[None]])

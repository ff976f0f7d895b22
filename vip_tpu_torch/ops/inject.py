"""Fake-companion injection of a whole radial ladder on the cube's device
(port of ``vip_tpu.ops.inject``).

The contrast curve and the completeness probes inject companions into a
base cube many times over; this builds each injected cube on the device
from the base cube and a few scalars, so that the cube crosses the host
link once. The arithmetic is the host injector's
(``fm.fakecomp.cube_inject_companions``): in frame f the companion sits
at position angle ``ang - angle_list[f]``; its shift splits into a
placement truncated to an integer (numpy's ``.astype(int)``, towards
zero, also for negative shifts) and a sub-pixel FFT shift of the PSF
stamp with a pad margin of 1; the flux scales the shifted stamp, and a
stamp overhanging the frame edge loses its outer rows and columns.

The placement and the sub-pixel shifts are computed on the host in
float64, as the host injector computes them, so that both place every
stamp on the same pixel. The rungs are added one after another, each into
one slice of the cube per frame (an indexed write whose indices are
distinct within a rung), never by an atomic scatter-add: the result is
the same bits on every run.
"""

import math

import numpy as np
import torch

from ..config.device import as_tensor
from .fft import _frame_center_static, fourier_shift_batch

__all__ = ["inject_ladder_adi"]


def _clip_gather(stamps, dy, dx):
    """``adj[f, i, j] = stamps[f, i - dy[f], j - dx[f]]``, zero outside:
    the stamp moved by (dy, dx) inside its own window (vip_tpu
    inject.py:28), so that a stamp overhanging the frame edge is written
    at an in-bounds corner without its out-of-frame rows and columns."""
    n, s, _ = stamps.shape
    ar = torch.arange(s, device=stamps.device)
    iy = ar[None, :] - dy[:, None]
    ix = ar[None, :] - dx[:, None]
    valid = (((iy >= 0) & (iy < s))[:, :, None]
             & ((ix >= 0) & (ix < s))[:, None, :])
    fr = torch.arange(n, device=stamps.device)[:, None, None]
    adj = stamps[fr, iy.clamp(0, s - 1)[:, :, None],
                 ix.clamp(0, s - 1)[:, None, :]]
    return torch.where(valid, adj, 0.0)


def inject_ladder_adi(cube, psf_stamp, angle_list, rads, fluxes, ang):
    """A copy of ``cube`` (n, Y, X) with a radial ladder of companions at
    azimuth ``ang`` [rad] (vip_tpu inject.py:48).

    ``psf_stamp``: (s, s) normalized PSF, s <= min(Y, X); ``angle_list``
    (n,) parallactic angles [deg]; ``rads``, ``fluxes``: (K,) radii [px]
    and fluxes of the rungs. A rung of zero flux is skipped (an exact
    no-op). Runs on the cube's device (numpy input goes to the default
    device) and returns a tensor there.
    """
    cube = as_tensor(cube)
    n, Y, X = cube.shape
    dev, dt = cube.device, cube.dtype
    stamp = as_tensor(psf_stamp, dev, dt)
    s = stamp.shape[-1]
    if s > min(Y, X):
        raise ValueError("the PSF stamp is larger than the frames")
    if isinstance(angle_list, torch.Tensor):
        angle_list = angle_list.detach().cpu().numpy()
    angles = np.asarray(angle_list, dtype=np.float64).reshape(-1)
    rads = np.asarray(rads, dtype=np.float64).reshape(-1)
    fluxes = np.asarray(fluxes, dtype=np.float64).reshape(-1)
    ceny, cenx = _frame_center_static(Y, X)
    w = int(math.ceil(s / 2)) - (s % 2)
    sty, stx = ceny - w, cenx - w

    pa = float(ang) - np.deg2rad(angles)                      # (n,)
    out = cube.clone()
    ar = torch.arange(s, device=dev)
    frames = torch.arange(n, device=dev)[:, None, None]
    stamps = stamp.expand(n, s, s)
    for rad, flux in zip(rads, fluxes):
        if flux == 0:
            continue
        shift_y = rad * np.sin(pa)
        shift_x = rad * np.cos(pa)
        inty = shift_y.astype(int)                             # truncation
        intx = shift_x.astype(int)
        shifted = fourier_shift_batch(stamps, shift_y - inty, shift_x - intx,
                                      1)
        y0 = sty + inty
        x0 = stx + intx
        cy0 = np.clip(y0, 0, Y - s)                            # in bounds
        cx0 = np.clip(x0, 0, X - s)
        adj = _clip_gather(shifted, torch.as_tensor(y0 - cy0, device=dev),
                           torch.as_tensor(x0 - cx0, device=dev))
        rows = (torch.as_tensor(cy0, device=dev)[:, None] + ar)[:, :, None]
        cols = (torch.as_tensor(cx0, device=dev)[:, None] + ar)[:, None, :]
        out[frames, rows, cols] = out[frames, rows, cols] + flux * adj
    return out

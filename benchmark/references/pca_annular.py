"""Plain reference of VIP's annular PCA-ADI of a 3-d cube,
``pca_annular(cube, angle_list, fwhm=f, ncomp=k, ...)`` with VIP's
defaults otherwise (radius_int 0, asize 4, n_segments 1, delta_rot
(0.1, 1), svd_mode 'lapack', min_frames_lib 2, max_frames_lib 200, imlib
'vip-fft', collapse 'median'). Every geometry is worked out again here
from VIP's definitions:

- the annuli: int((y/2 - radius_int)/asize) of them about the frame
  center (VIP's frame_center), annulus a holding the pixels at radii
  [radius_int + a·asize, + asize), the last one widened one pixel
  inwards; where the last two meet, the last one's residuals are kept;
  one segment covers the whole ring;
- the PA threshold of annulus a: 2·atan(δ_a·fwhm / (2·c_a)) degrees,
  c_a the annulus's center radius, δ_a the delta_rot pair spaced
  linearly over the annuli. VIP's pca_annular asks ``_define_annuli`` to
  be strict, which leaves the threshold as computed: the cap at 90% of
  half the rotation range (:func:`pa_threshold` with ``strict=False``)
  does not apply;
- each frame's library (VIP's ``_find_indices_adi`` with
  ``truncate=True``): the frames before the first one within the
  threshold of the frame, and those from the first one beyond it after
  the frame; where more than min(n - 1, max_frames_lib) are left, those
  of least |ΔPA| (numpy's argsort order), in frame order;
- each frame's annulus pixels minus their projection on the top
  min(ncomp, L, pixels) right singular vectors of its L-row library, no
  centering;
- the residual frames derotated with VIP's exact FFT rotation
  (``plain.derotate``) and their median (``plain.median0``).

Departures from VIP:

- the right singular vectors are taken from ``torch.linalg.eigh`` of the
  library's Gram matrix, v_j = uⱼᵀ·lib / √λⱼ: the same vectors as
  LAPACK's SVD up to sign, which the projection does not see. The Grams
  are the (L, L) blocks of the annulus's Gram matrix, their products
  through ``plain.mm`` in the precision asked for;
- the eigh runs on the CPU's LAPACK, the frames split over a pool of
  threads (on the card, ``torch.linalg.eigh`` of a batch is one cuSOLVER
  call a matrix);
- the angles are used as given: VIP's ``check_pa_vector`` changes only
  negative angles and jumps of over 180 degrees, and this reference
  raises on those;
- only ``fwhm``, ``ncomp`` and the defaults above are computed; any other
  keyword or value raises.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yardstick import plain
from yardstick.params import take

DEFAULTS = {"ncomp": 1, "radius_int": 0, "asize": 4, "n_segments": 1,
            "delta_rot": (0.1, 1), "svd_mode": "lapack",
            "min_frames_lib": 2, "max_frames_lib": 200, "imlib": "vip-fft",
            "collapse": "median"}
ALLOWED = {"radius_int": (0,), "asize": (4,), "n_segments": (1,),
           "delta_rot": ((0.1, 1),), "svd_mode": ("lapack", "eigen"),
           "min_frames_lib": (2,), "max_frames_lib": (200,),
           "imlib": ("vip-fft",), "collapse": ("median",)}

# frames whose library rows are gathered at once
_FRAMES_A_BLOCK = 64


def annuli(y, x, radius_int, asize):
    """[(center radius, flat pixel indices)] of each annulus of a y x x
    frame, as VIP's ``_define_annuli`` and ``get_annulus_segments``
    (one segment) lay them out."""
    cy = y / 2 - (0.5 if y % 2 else 0.0)
    cx = x / 2 - (0.5 if x % 2 else 0.0)
    yy, xx = np.mgrid[:y, :x]
    rad = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    count = int((y / 2 - radius_int) / asize)
    out = []
    for a in range(count):
        inner = radius_int + a * asize - (1 if a == count - 1 else 0)
        ring = (rad >= inner) & (rad < inner + asize)
        out.append((inner + asize / 2, np.flatnonzero(ring)))
    return out


def pa_threshold(center, fwhm, delta_rot, angles, strict=True):
    """The PA threshold (degrees) of an annulus centered at ``center`` px:
    the angle that ``delta_rot``·fwhm subtends there. Unless ``strict``
    it is capped at 90% of half the rotation range, as VIP's
    ``_define_annuli`` does for its other callers."""
    thr = float(np.rad2deg(2 * np.arctan(delta_rot * fwhm / (2 * center))))
    half = abs(float(np.max(angles)) - float(np.min(angles))) / 2
    if not strict and thr >= 0.9 * half:
        thr = 0.9 * half
    return thr


def library(angles, frame, thr, max_frames=200):
    """The frames of ``frame``'s library (VIP's ``_find_indices_adi`` with
    ``truncate=True``), in frame order."""
    n = len(angles)
    dpa = np.abs(angles - angles[frame])
    near = np.flatnonzero(dpa[:frame] < thr)
    first = int(near[0]) if near.size else frame
    far = np.flatnonzero(dpa[frame:] > thr)
    after = frame + int(far[0]) if far.size else n
    idx = np.concatenate([np.arange(0, first), np.arange(after, n)])
    keep = min(n - 1, max_frames)
    if idx.size > keep:
        idx = np.sort(idx[np.argsort(dpa[idx])][:keep])
    return idx


def _eigh(G):
    """``torch.linalg.eigh`` of a (g, L, L) batch on the CPU, the batch
    split over a pool of threads with one LAPACK thread each; the results
    on ``G``'s device."""
    host = G.cpu()
    workers = max(1, min(len(host), len(os.sched_getaffinity(0))))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(workers) as pool:
            parts = list(pool.map(torch.linalg.eigh, host.chunk(workers)))
    finally:
        torch.set_num_threads(threads)
    return (torch.cat([e for e, _ in parts]).to(G.device),
            torch.cat([u for _, u in parts]).to(G.device))


def _residuals(M, libs, ncomp, precision):
    """Each frame's row of the annulus matrix M (n, p) minus its
    projection on the top right singular vectors of its library, the
    frames of ``libs`` ({frame: library rows}) grouped by library size.
    Returns (n, p)."""
    n, p = M.shape
    G = plain.mm(M, M.T, precision)
    out = torch.empty_like(M)
    sizes = {}
    for f, rows in libs.items():
        sizes.setdefault(len(rows), []).append(f)
    for L, frames in sorted(sizes.items()):
        k = min(ncomp, L, p)
        fr = torch.as_tensor(frames, device=M.device)
        idx = torch.as_tensor(np.stack([libs[f] for f in frames]),
                              device=M.device)
        e, U = _eigh(G[idx[:, :, None], idx[:, None, :]])
        U, s = U[..., -k:], torch.sqrt(e[..., -k:])
        for b in range(0, len(frames), _FRAMES_A_BLOCK):
            sl = slice(b, b + _FRAMES_A_BLOCK)
            V = plain.mm(U[sl].mT, M[idx[sl]], precision) / s[sl, :, None]
            x = M[fr[sl]][:, :, None]                          # (g, p, 1)
            coef = plain.mm(V, x, precision)                   # (g, k, 1)
            out[fr[sl]] = (x - plain.mm(V.mT, coef, precision))[..., 0]
    return out


def reduce(cube, angles, kwargs, precision="float64"):
    p = take(kwargs, DEFAULTS, ALLOWED)
    if "fwhm" not in kwargs:
        raise ValueError("the reference needs the sequence's fwhm")
    fwhm = float(kwargs["fwhm"])
    angles = np.asarray(angles, dtype=np.float64)
    if np.any(angles < 0) or np.any(np.abs(np.diff(angles)) > 180):
        raise ValueError("the reference takes angles in [0, 360) with no "
                         "jump over 180 degrees")
    n, y, x = cube.shape
    geometry = annuli(y, x, p["radius_int"], p["asize"])
    deltas = np.linspace(*p["delta_rot"], num=len(geometry))
    flat = cube.reshape(n, y * x).to(plain.real_dtype(precision))
    res = torch.zeros_like(flat)
    for (center, pix), delta in zip(geometry, deltas):
        thr = pa_threshold(center, fwhm, delta, angles)
        libs = {f: library(angles, f, thr, p["max_frames_lib"])
                for f in range(n)}
        if min(len(v) for v in libs.values()) < p["min_frames_lib"]:
            raise ValueError("too few frames left in a PCA library")
        pix_d = torch.as_tensor(pix, device=cube.device)
        res[:, pix_d] = _residuals(flat[:, pix_d], libs, int(p["ncomp"]),
                                   precision)
    der = plain.derotate(res.reshape(n, y, x), angles, precision)
    del res
    return plain.median0(der)

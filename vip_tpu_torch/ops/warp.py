"""OpenCV's ``warpAffine`` and ``resize`` computed on tensors.

vip_tpu calls OpenCV for its 'opencv' and 'skimage' imlibs. The card's
machine has no OpenCV, so the port computes what OpenCV 5.0.0 computes,
batched over frames on the tensor's device. It never imports cv2.

``warp_affine`` maps each output pixel through the inverse of its frame's
2x3 matrix (as ``cv2.invertAffineTransform``) and interpolates there.
OpenCV 5.0.0 has two code paths, chosen by the dtype it is given, and
vip_tpu reaches both: 'opencv' casts its frames to float32, 'skimage' to
float64. ``path`` names the one to follow. The two differ:

================  ===========================  ===========================
interpolation     ``path="float32"``           ``path="float64"``
================  ===========================  ===========================
nearest           float32 source coordinate,   fixed point: 1/1024 steps,
                  rounded                      floored after +1/2
linear            float32 coordinate,          fixed point: 1/1024, then
                  unquantized weights          1/32 steps; 1/32 weights
cubic             float32 coordinate,          as ``"float32"`` (see below)
                  unquantized a = -0.75 taps
lanczos4          fixed point as float64's,    fixed point, 1/32 steps,
                  OpenCV's float32 tables      OpenCV's float32 tables
================  ===========================  ===========================

The fixed-point paths are bit-equal to OpenCV in float64 (the Lanczos
tables are rebuilt in float32 as ``interpolateLanczos4`` builds them).
The float32 paths agree within float32 rounding. OpenCV's float64 cubic
path agrees with the unquantized float32-coordinate cubic at 5e-7 in the
interior, and returns values no formula here reproduces at the pixels
whose 4x4 taps leave the frame (ROADMAP Queue 3); the port computes the
cubic with the border rule there.

Borders ('constant' is zero): constant, replicate, reflect (abc|cba),
reflect101 (abc|ba), wrap. ``resize`` is ``cv2.resize(frame, (0, 0),
fx=, fy=)`` for float32 frames: destination pixels map through 1/fx (not
through the ratio of the sizes), the taps are clamped to the frame, and
each axis is one matrix, so a batch is two matmuls.
"""

import numpy as np
import torch

__all__ = ["warp_affine", "resize", "rotation_matrix", "INTERPOLATIONS",
           "BORDERS", "VIP_INTERPOLATIONS"]

INTERPOLATIONS = ("nearest", "linear", "cubic", "lanczos4")
BORDERS = ("constant", "replicate", "reflect", "reflect101", "wrap")
# vip_tpu's names of them in its 'opencv' shifts and rescalings (the
# rotations add the 'skimage' orders, preproc.derotation)
VIP_INTERPOLATIONS = {"bilinear": "linear", "bicubic": "cubic",
                      "nearneig": "nearest", "lanczos4": "lanczos4"}

# the interpolation taps about floor(source coordinate)
_OFFSETS = {"linear": (0, 1), "cubic": (-1, 0, 1, 2),
            "lanczos4": (-3, -2, -1, 0, 1, 2, 3, 4)}

# bytes a chunk of frames may take; a pixel holds its coordinates, and per
# tap of an axis an int64 index, a mask and a weight (``_pixel_bytes``)
_CHUNK_BYTES = 4 << 30

_S45 = 0.70710678118654752440084436210485
_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45),
       (0, -1), (-_S45, _S45))


def _lanczos4_f32(x):
    """OpenCV's ``interpolateLanczos4`` of float32 offsets ``x`` (array):
    the eight float32 coefficients, normalized in float32 (k, 8)."""
    f32 = np.float32
    x = np.asarray(x, np.float32).reshape(-1)
    y0 = -(x.astype(np.float64) + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    co = np.zeros((x.size, 8), np.float32)
    for i in range(8):
        d = (x + f32(3) - f32(i)).astype(np.float32)
        y = -d.astype(np.float64) * np.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            v = (_CS[i][0] * s0 + _CS[i][1] * c0) / (y * y)
        co[:, i] = np.where(np.abs(d) >= 1e-6, v, 1e30).astype(np.float32)
    s = np.zeros(x.size, np.float32)
    for i in range(8):
        s = (s + co[:, i]).astype(np.float32)
    s = (f32(1) / s).astype(np.float32)
    return (co * s[:, None]).astype(np.float32)


# OpenCV's INTER_TAB_SIZE offsets k/32, as float32 products
_LANCZOS_TAB = _lanczos4_f32(np.float32(1.0 / 32)
                             * np.arange(32, dtype=np.float32))


def _cubic_weights(t):
    """OpenCV's ``interpolateCubic`` (a = -0.75) at offsets ``t`` in
    [0, 1): the weights of taps -1, 0, 1, 2 (list of four)."""
    a = -0.75
    x = t + 1
    w0 = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    u = 1 - t
    w2 = ((a + 2) * u - (a + 3)) * u * u + 1
    return [w0, w1, w2, 1 - w0 - w1 - w2]


def _border(i, n, mode):
    """Border index of integer tensor ``i`` on an axis of ``n`` pixels:
    (index inside the axis, in-frame mask or None)."""
    if mode == "constant":
        return i.clamp(0, n - 1), (i >= 0) & (i < n)
    if mode == "replicate":
        return i.clamp(0, n - 1), None
    if mode == "wrap":
        return torch.remainder(i, n), None
    if mode == "reflect":
        p = torch.remainder(i, 2 * n)
        return torch.where(p < n, p, 2 * n - 1 - p), None
    if mode == "reflect101":
        if n == 1:
            return torch.zeros_like(i), None
        p = torch.remainder(i, 2 * n - 2)
        return torch.where(p < n, p, 2 * n - 2 - p), None
    raise ValueError(f"border mode {mode!r} not recognized")


def rotation_matrix(cx, cy, angles):
    """``cv2.getRotationMatrix2D((cx, cy), angle, 1)`` of each angle
    (degrees, counter-clockwise): (n, 2, 3) float64 numpy."""
    t = np.deg2rad(np.asarray(angles, dtype=np.float64).reshape(-1))
    alpha, beta = np.cos(t), np.sin(t)
    M = np.empty((t.size, 2, 3))
    M[:, 0, 0], M[:, 0, 1] = alpha, beta
    M[:, 0, 2] = (1 - alpha) * cx - beta * cy
    M[:, 1, 0], M[:, 1, 1] = -beta, alpha
    M[:, 1, 2] = beta * cx + (1 - alpha) * cy
    return M


def _invert(M):
    """``cv2.invertAffineTransform`` of (n, 2, 3) float64 matrices."""
    d = M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0]
    with np.errstate(divide="ignore"):
        d = np.where(d != 0, 1.0 / d, 0.0)
    A = np.empty_like(M)
    A[:, 0, 0], A[:, 1, 1] = M[:, 1, 1] * d, M[:, 0, 0] * d
    A[:, 0, 1], A[:, 1, 0] = -M[:, 0, 1] * d, -M[:, 1, 0] * d
    A[:, 0, 2] = -A[:, 0, 0] * M[:, 0, 2] - A[:, 0, 1] * M[:, 1, 2]
    A[:, 1, 2] = -A[:, 1, 0] * M[:, 0, 2] - A[:, 1, 1] * M[:, 1, 2]
    return A


def _fixed_coords(A, H, W, nearest, dev):
    """OpenCV's fixed-point source coordinates of a chunk's inverse maps
    ``A`` (c, 2, 3): integer (iy, ix) of (c, H, W) and, unless
    ``nearest``, the 1/32 fractions (fy, fx) as int64."""
    xs, ys = np.arange(W), np.arange(H)
    rd = 512 if nearest else 16
    adelta = np.rint(A[:, 0, 0, None] * xs * 1024).astype(np.int64)
    bdelta = np.rint(A[:, 1, 0, None] * xs * 1024).astype(np.int64)
    X0 = np.rint((A[:, 0, 1, None] * ys + A[:, 0, 2, None]) * 1024).astype(
        np.int64) + rd
    Y0 = np.rint((A[:, 1, 1, None] * ys + A[:, 1, 2, None]) * 1024).astype(
        np.int64) + rd
    X = (torch.as_tensor(X0, device=dev)[:, :, None]
         + torch.as_tensor(adelta, device=dev)[:, None, :])
    Y = (torch.as_tensor(Y0, device=dev)[:, :, None]
         + torch.as_tensor(bdelta, device=dev)[:, None, :])
    if nearest:
        return Y >> 10, X >> 10, None, None
    X, Y = X >> 5, Y >> 5
    return Y >> 5, X >> 5, Y & 31, X & 31


def _float_coords(A, H, W, dev):
    """OpenCV's float32 source coordinates x' = a·x + (b·y + c) of a
    chunk's inverse maps ``A`` (c, 2, 3): float32 (sy, sx) of (c, H, W)."""
    A32 = torch.as_tensor(A.astype(np.float32), device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)

    def one(r):
        row = A32[:, r, 1, None] * ys + A32[:, r, 2, None]
        return A32[:, r, 0, None, None] * xs + row[:, :, None]

    return one(1), one(0)


def _axis_taps(i0, offsets, n, border):
    """Per tap: (index, mask or None) on an axis of ``n`` pixels."""
    return [_border(i0 + o, n, border) for o in offsets]


def _warp_chunk(frames, A, H, W, interpolation, border, path):
    c, h, w = frames.shape
    dev, dt = frames.device, frames.dtype
    fixed = interpolation == "lanczos4" or (
        path == "float64" and interpolation != "cubic")
    flat = frames.reshape(c, h * w)

    def gather(yi, xi, ok):
        v = flat.gather(1, (yi * w + xi).reshape(c, -1)).reshape(c, H, W)
        return v if ok is None else torch.where(ok, v, 0.0)

    def both(oky, okx):
        if oky is None:
            return okx
        return oky if okx is None else oky & okx

    if interpolation == "nearest":
        if fixed:
            iy, ix, _, _ = _fixed_coords(A, H, W, True, dev)
        else:
            sy, sx = _float_coords(A, H, W, dev)
            iy, ix = torch.round(sy).long(), torch.round(sx).long()
        yi, oky = _border(iy, h, border)
        xi, okx = _border(ix, w, border)
        return gather(yi, xi, both(oky, okx))

    offs = _OFFSETS[interpolation]
    if fixed:
        iy, ix, fy, fx = _fixed_coords(A, H, W, False, dev)
        if interpolation == "linear":
            ty, tx = fy.to(dt) / 32, fx.to(dt) / 32
            wy, wx = [1 - ty, ty], [1 - tx, tx]
        else:
            tab = torch.as_tensor(_LANCZOS_TAB, device=dev)
            wy = [tab[:, r][fy] for r in range(8)]
            wx = [tab[:, r][fx] for r in range(8)]
    else:
        sy, sx = _float_coords(A, H, W, dev)
        fy32, fx32 = torch.floor(sy), torch.floor(sx)
        ty, tx = (sy - fy32).to(dt), (sx - fx32).to(dt)
        iy, ix = fy32.long(), fx32.long()
        if interpolation == "linear":
            wy, wx = [1 - ty, ty], [1 - tx, tx]
        else:
            wy, wx = _cubic_weights(ty), _cubic_weights(tx)
    rows = _axis_taps(iy, offs, h, border)
    cols = _axis_taps(ix, offs, w, border)
    out = None
    for (yi, oky), wr in zip(rows, wy):
        for (xi, okx), wc in zip(cols, wx):
            if interpolation == "lanczos4":
                # OpenCV's 2-d table holds the float32 product
                wt = (wr * wc).to(dt)
            else:
                wt = wr * wc
            term = wt * gather(yi, xi, both(oky, okx))
            out = term if out is None else out + term
    return out


def warp_affine(cube, M, out_shape, interpolation="linear",
                border_mode="constant", path="float32"):
    """``cv2.warpAffine(frame, M[i], (W, H), flags=interpolation,
    borderMode=border_mode)`` of every frame of a (n, h, w) tensor, in
    frame chunks on the tensor's device, in its dtype.

    ``M``: (2, 3) or (n, 2, 3) forward matrices (array-like, float64 as
    OpenCV takes them); ``out_shape`` (H, W); ``interpolation`` one of
    :data:`INTERPOLATIONS`; ``border_mode`` one of :data:`BORDERS` (the
    constant border is 0); ``path`` "float32" or "float64", the OpenCV code
    path to follow (module docstring). The frames are interpolated as
    given: a caller that follows vip_tpu's float32 cast rounds them first.
    """
    if interpolation not in INTERPOLATIONS:
        raise NotImplementedError(
            f"warp_affine: interpolation {interpolation!r} is not one of "
            f"{INTERPOLATIONS}")
    if border_mode not in BORDERS:
        raise NotImplementedError(
            f"warp_affine: border mode {border_mode!r} is not one of "
            f"{BORDERS}")
    if path not in ("float32", "float64"):
        raise ValueError(f"warp_affine: path {path!r} is not 'float32' or "
                         "'float64'")
    n, h, w = cube.shape
    H, W = int(out_shape[0]), int(out_shape[1])
    M = np.asarray(M, dtype=np.float64)
    if M.ndim == 2:
        M = np.broadcast_to(M, (n, 2, 3))
    A = _invert(np.ascontiguousarray(M))
    out = cube.new_empty((n, H, W))
    taps = len(_OFFSETS.get(interpolation, (0,)))
    step = int(max(1, _CHUNK_BYTES // ((48 * taps + 64) * max(H * W,
                                                              h * w))))
    for s in range(0, n, step):
        e = min(n, s + step)
        out[s:e] = _warp_chunk(cube[s:e], A[s:e], H, W, interpolation,
                               border_mode, path)
    return out


def _resize_axis(nin, nout, scale, interpolation):
    """(nout, nin) float64 matrix of one axis of ``cv2.resize`` of a
    float32 frame, ``scale`` = 1/f: nearest takes floor(d·scale); the
    others sample (d + 1/2)·scale - 1/2, taps clamped to the axis
    (linear: the coordinate is clamped)."""
    A = np.zeros((nout, nin))
    d = np.arange(nout)
    if interpolation == "nearest":
        A[d, np.minimum(np.floor(d * scale).astype(int), nin - 1)] = 1
        return A
    # OpenCV's lanczos4 offsets are float32; the others match float64
    f = (d + 0.5) * scale - 0.5
    if interpolation == "lanczos4":
        f = f.astype(np.float32)
    s = np.floor(f).astype(int)
    t = (f - s).astype(f.dtype)
    if interpolation == "linear":
        lo, hi = s < 0, s >= nin - 1
        t = np.where(lo | hi, 0.0, t)
        s = np.where(lo, 0, np.where(hi, nin - 1, s))
        W = np.stack([1 - t, t], -1)
    elif interpolation == "cubic":
        W = np.stack(_cubic_weights(t), -1)
    else:
        W = _lanczos4_f32(t)
    off = _OFFSETS[interpolation][0]
    for k in range(W.shape[1]):
        np.add.at(A, (d, np.clip(s + off + k, 0, nin - 1)),
                  W[:, k].astype(np.float64))
    return A


def resize(cube, fx, fy, interpolation="linear"):
    """``cv2.resize(frame, (0, 0), fx=fx, fy=fy, interpolation=...)`` of
    every frame of a (n, h, w) tensor (OpenCV's float32 semantics): the
    output is (n, round(h·fy), round(w·fx)), each axis one matrix, the
    batch two matmuls in the tensor's dtype on its device."""
    if interpolation not in INTERPOLATIONS:
        raise NotImplementedError(
            f"resize: interpolation {interpolation!r} is not one of "
            f"{INTERPOLATIONS}")
    n, h, w = cube.shape
    H = int(np.rint(h * fy))
    W = int(np.rint(w * fx))
    Ay = torch.as_tensor(_resize_axis(h, H, 1.0 / fy, interpolation),
                         dtype=cube.dtype, device=cube.device)
    Ax = torch.as_tensor(_resize_axis(w, W, 1.0 / fx, interpolation),
                         dtype=cube.dtype, device=cube.device)
    return torch.matmul(torch.matmul(Ay, cube), Ax.T)

"""Batched interpolation rotation (port of ``vip_tpu.ops.interp_rotation``).

vip_tpu's own speed-mode rotation, not OpenCV's: every output pixel maps
through the inverse rotation about VIP's frame center (d/2 for an even
side, (d-1)/2 for an odd one) to an unquantized source coordinate, which
is sampled with 4 bilinear or 16 bicubic (a = -0.75) taps; taps outside
the frame read zero. The frames are rotated in chunks of whole frames on
the tensor's device, each tap one gather.
"""

import torch

from .warp import _cubic_weights

__all__ = ["rotate_interp_batch", "rotate_interp"]

# bytes a chunk may take: ~120 bytes a pixel of coordinates, indices,
# weights and one tap's gather
_CHUNK_BYTES = 1 << 30


def _source_coords(ny, nx, angles):
    """Inverse-rotation sampling grid of each angle about the frame center
    (cv2.getRotationMatrix2D's convention: a positive angle turns the
    image counter-clockwise), (B, ny, nx) each, in the angles' dtype."""
    cy = ny / 2 if ny % 2 == 0 else (ny - 1) / 2
    cx = nx / 2 if nx % 2 == 0 else (nx - 1) / 2
    theta = -torch.deg2rad(angles)[:, None, None]
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    y0 = (torch.arange(ny, dtype=angles.dtype, device=angles.device)
          - cy)[:, None]
    x0 = torch.arange(nx, dtype=angles.dtype, device=angles.device) - cx
    xs = cos_t * x0 + sin_t * y0 + cx
    ys = -sin_t * x0 + cos_t * y0 + cy
    return ys, xs


def _rotate_chunk(frames, angles, mode):
    B, ny, nx = frames.shape
    ys, xs = _source_coords(ny, nx, angles)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ty, tx = ys - y0, xs - x0
    y0i, x0i = y0.long(), x0.long()
    flat = frames.reshape(B, ny * nx)
    if mode == "bilinear":
        offs, wys, wxs = (0, 1), (1 - ty, ty), (1 - tx, tx)
    else:
        offs, wys, wxs = (-1, 0, 1, 2), _cubic_weights(ty), _cubic_weights(tx)

    out = None
    for dy, wy in zip(offs, wys):
        yi = y0i + dy
        yok = (yi >= 0) & (yi < ny)
        yc = yi.clamp(0, ny - 1) * nx
        row = None
        for dx, wx in zip(offs, wxs):
            xi = x0i + dx
            ok = yok & (xi >= 0) & (xi < nx)
            v = flat.gather(1, (yc + xi.clamp(0, nx - 1)).reshape(B, -1))
            term = wx * torch.where(ok, v.reshape(B, ny, nx), 0.0)
            if mode == "bilinear":
                term = wy * term
                out = term if out is None else out + term
            else:
                row = term if row is None else row + term
        if mode != "bilinear":
            out = wy * row if out is None else out + wy * row
    return out


def rotate_interp_batch(cube, angles, mode="bicubic"):
    """Rotate every frame of a (n, y, x) tensor by its own angle (degrees,
    counter-clockwise) (vip_tpu interp_rotation.py:101). ``mode``:
    'bilinear' or 'bicubic' (any other value is bicubic, as in vip_tpu).
    Runs on the cube's device, in its dtype."""
    n, ny, nx = cube.shape
    angles = torch.as_tensor(angles, dtype=cube.dtype,
                             device=cube.device).reshape(-1)
    if angles.numel() == 1 and n != 1:
        angles = angles.expand(n)
    out = torch.empty_like(cube)
    step = int(max(1, _CHUNK_BYTES // (120 * ny * nx)))
    for s in range(0, n, step):
        out[s:s + step] = _rotate_chunk(cube[s:s + step], angles[s:s + step],
                                        mode)
    return out


def rotate_interp(frame, angle, mode="bicubic"):
    """Rotate a single frame by ``angle`` degrees (counter-clockwise)
    (vip_tpu interp_rotation.py:117)."""
    return rotate_interp_batch(frame[None], [float(angle)], mode=mode)[0]

"""Plain PyTorch building blocks of the references: VIP's exact rotation,
its FFT zoom, its spectral rescaling, the top principal components, and
numpy's median. They import nothing of the program and take nothing that
the program made; every geometry is worked out again here.

``precision`` is "float64" (the reference), "tf32" (its control: float32
with every matrix product in TF32, the step below the program's float32
with TF32 off) or "float32" (a plain float32 witness, TF32 off).
"""

import math

import numpy as np
import torch

from .roofline import vip_fft_canvas

PRECISIONS = ("float64", "float32", "tf32")


def real_dtype(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def _round_tf32(x):
    """x (float32) rounded to the nearest TF32 value (10 mantissa bits),
    ties away from 0, as the tensor cores' conversion."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a, b, precision):
    """a @ b in ``precision``; in TF32 the operands are rounded to TF32
    and the products summed in float32, as the tensor cores do, on every
    device and for every shape (cuBLAS keeps some skinny products in
    float32 even with TF32 allowed)."""
    if precision != "tf32":
        return a @ b
    return _round_tf32(a) @ _round_tf32(b)


# ---------------------------------------------------------------------------
# VIP's exact rotation ('vip-fft'): the frame on a ~4x zero canvas, a
# quarter turn about the canvas center, three FFT shears, the crop back
# ---------------------------------------------------------------------------
def _quadrant(angle):
    """(k, dangle) with angle = 90·k + dangle (mod 360), dangle in
    (-45, 45], as VIP's rotate_fft reduces an angle in degrees."""
    angle = angle % 360.0
    if angle <= 45.0:
        return 0, angle
    dangle = angle % 90.0
    if dangle > 45.0:
        dangle -= 90.0
    return int(np.rint(angle / 90.0)) % 4, dangle


def _shear(z, c, dim):
    """Shift every line of the complex canvases z (B, N, N) along ``dim``
    by c·q, q the line's coordinate from the canvas center N/2, through
    its DFT: the phase exp(-2πi·c·q·f), f the signed frequency."""
    B, N = z.shape[0], z.shape[-1]
    f = torch.fft.fftfreq(N, dtype=torch.float64, device=z.device)
    q = torch.arange(N, dtype=torch.float64, device=z.device) - N / 2
    ramp = torch.outer(q, f) if dim == 2 else torch.outer(f, q)
    ang = (-2 * math.pi) * c.to(torch.float64)[:, None, None] * ramp
    phase = torch.polar(torch.ones_like(ang), ang).to(z.dtype)
    return torch.fft.ifft(torch.fft.fft(z, dim=dim) * phase, dim=dim)


def rotate(frames, angles, precision="float64", chunk=8):
    """Rotate even square frames (n, y, y) by ``angles`` degrees (host
    float64, counter-clockwise in VIP's sense) as VIP's ``frame_rotate``
    with imlib 'vip-fft' does. Returns (n, y, y) in ``precision``."""
    n, y, x = frames.shape
    if y != x:
        raise ValueError("square frames only")
    N, p0 = vip_fft_canvas(y)
    rdt = real_dtype(precision)
    cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
    dev = frames.device
    out = torch.empty((n, y, y), dtype=rdt, device=dev)
    for s in range(0, n, chunk):
        part = frames[s:s + chunk].to(rdt)
        B = part.shape[0]
        # the canvas on an (N+1)² extension: the quarter turn is then about
        # the pixel (N/2, N/2), as VIP turns even frames
        ext = torch.zeros((B, N + 1, N + 1), dtype=rdt, device=dev)
        ext[:, p0:p0 + y, p0:p0 + y] = part
        work = torch.empty((B, N, N), dtype=rdt, device=dev)
        a = torch.empty(B, dtype=torch.float64)
        b = torch.empty(B, dtype=torch.float64)
        for i, ang in enumerate(angles[s:s + chunk]):
            k, dangle = _quadrant(float(ang))
            work[i] = torch.rot90(ext[i], k, dims=(0, 1))[:N, :N]
            rad = math.radians(dangle)
            a[i], b[i] = math.tan(rad / 2), -math.sin(rad)
        del ext
        a, b = a.to(dev), b.to(dev)
        z = _shear(work.to(cdt), a, dim=2)
        del work
        z = _shear(z, b, dim=1)
        z = _shear(z, a, dim=2)
        out[s:s + B] = z.real[:, p0:p0 + y, p0:p0 + y]
    return out


def derotate(cube, angles, precision="float64"):
    """VIP's ``cube_derotate`` with imlib 'vip-fft': frame i turned by
    -angles[i]."""
    return rotate(cube, -np.asarray(angles, dtype=np.float64), precision)


# ---------------------------------------------------------------------------
# VIP's FFT zoom (scale_fft) and the spectral rescaling of an IFS cube
# ---------------------------------------------------------------------------
def _zoom_geometry(dim, scale):
    """(kd, kf): the zero padding of the frame and of its spectrum whose
    canvases dim + 2·kd and dim + 2·kf come nearest to the ratio
    ``scale`` (VIP's scale_fft)."""
    kd = np.arange(dim / 2 + 1, dtype=int)
    yy = dim / 2 * (scale - 1) + kd.astype(float) * scale
    kf = np.round(yy).astype(int)
    i = int(np.nanargmin(np.abs(yy - kf)))
    return int(kd[i]), int(kf[i])


def zoom(frames, scale, precision="float64"):
    """Zoom even square frames (B, dim, dim) by ``scale`` about their
    center through their spectra, keeping the frame size (VIP's scale_fft
    with ori_dim=True; flux is conserved, so values scale by about
    1/scale²)."""
    rdt = real_dtype(precision)
    frames = frames.to(rdt)
    if scale == 1:
        return frames
    B, dim = frames.shape[0], frames.shape[-1]
    if dim % 2 or frames.shape[-2] != dim:
        raise ValueError("even square frames only")
    kd, kf = _zoom_geometry(dim, scale)
    dp, dpp = dim + 2 * kd, dim + 2 * kf
    big = torch.zeros((B, dp, dp), dtype=rdt, device=frames.device)
    big[:, kd:kd + dim, kd:kd + dim] = frames
    spec = torch.fft.fftshift(torch.fft.fft2(big), dim=(-2, -1))
    del big
    if dpp > dp:
        o = (dpp - dp) // 2
        tmp = spec.new_zeros((B, dpp, dpp))
        tmp[:, o:o + dp, o:o + dp] = spec
    else:
        o = (dp - dpp) // 2
        tmp = spec[:, o:o + dpp, o:o + dpp]
    del spec
    out = torch.fft.ifft2(torch.fft.ifftshift(tmp, dim=(-2, -1))).real
    if dpp > dim:
        return out[:, kf:kf + dim, kf:kf + dim]
    res = frames.new_zeros((B, dim, dim))
    res[:, -kf:-kf + dpp, -kf:-kf + dpp] = out
    return res


def rescale_channels(cube4, scales, precision="float64"):
    """VIP's ``cube_rescaling_wavelengths`` forward pass of a (z, n, y, y)
    cube with imlib 'vip-fft': every frame padded by reflection to the
    side the largest scale needs (parity kept), each channel zoomed by its
    scale. Returns (z, n, Y, Y)."""
    z, n, y, x = cube4.shape
    smax = float(np.max(scales))
    Y = y
    if smax > 1:
        Y = int(np.ceil(smax * y))
        if (Y - y) % 2:
            Y += 1
    p = (Y - y) // 2
    out = torch.empty((z, n, Y, Y), dtype=real_dtype(precision),
                      device=cube4.device)
    for c in range(z):
        ch = cube4[c].to(out.dtype)
        if p:
            ch = torch.nn.functional.pad(ch[:, None], (p, p, p, p),
                                         mode="reflect")[:, 0]
        out[c] = zoom(ch, float(scales[c]), precision)
    return out


def unscale_channels(cube4, scales, y_out, precision="float64"):
    """The inverse pass: each channel zoomed by 1/scale, then the central
    ``y_out`` px kept when the frames are larger. Returns (z, n, y_out,
    y_out)."""
    z, n, Y, _ = cube4.shape
    out = torch.stack([zoom(cube4[c], 1.0 / float(scales[c]), precision)
                       for c in range(z)])
    return center_crop(out, y_out)


def center_crop(frames, size):
    """The central ``size`` px of even frames (VIP's get_square about the
    frame center, for even sizes)."""
    Y = frames.shape[-1]
    if Y == size:
        return frames
    y0 = int(Y / 2 - (size - 1) / 2)
    return frames[..., y0:y0 + size, y0:y0 + size]


# ---------------------------------------------------------------------------
# Principal components and collapses
# ---------------------------------------------------------------------------
def pca_residuals(M, ncomp, precision="float64"):
    """M minus its projection on its top ``ncomp`` right singular vectors,
    for a (..., n, p) matrix or batch, the vectors taken from the eigh of
    the Gram matrix M Mᵀ. Returns the residuals in ``precision``."""
    M = M.to(real_dtype(precision))
    G = mm(M, M.mT, precision)
    e, U = torch.linalg.eigh(G)
    U = U[..., -ncomp:]
    S = torch.sqrt(torch.clamp(e[..., -ncomp:], min=0))
    V = mm(U.mT, M, precision) / S[..., :, None]
    return M - mm(mm(M, V.mT, precision), V, precision)


def median0(x, block=1 << 16):
    """numpy's median over the first axis (the mean of the two middle
    values for an even count) of (n, ...), in blocks of pixels."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    out = torch.empty(flat.shape[1], dtype=x.dtype, device=x.device)
    for s in range(0, flat.shape[1], block):
        v = torch.sort(flat[:, s:s + block], dim=0).values
        out[s:s + block] = v[n // 2] if n % 2 else \
            0.5 * (v[n // 2 - 1] + v[n // 2])
    return out.reshape(x.shape[1:])

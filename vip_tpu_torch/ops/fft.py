"""FFT three-shear rotation on ``torch.fft`` (port of ``vip_tpu.ops.fft``).

VIP's exact rotation (vip_hci/preproc/derotation.py:542-640): quadrant
``rot90``, then an x-shear by a = tan(θ/2), a y-shear by b = −sin θ and an
x-shear by a again, each a 1-D DFT, a phase ramp and an inverse DFT about
the (N/2, N/2) center of an even canvas. Float64 frames compute in
complex128 (the parity mode), float32 frames in complex64.

The quadrant decomposition runs in the frames' dtype, so that its
boundaries (45°, 135°, …) fall as they do in vip_tpu. The residual angle,
the shear coefficients a and b and the phase exp(−2πi·c·(q−N/2)·k/N) are
then evaluated in float64 and cast to the working complex dtype: in
float32, ``angle % 360`` rounds for negative angles (−79.79592° → 280.204°
loses ~1.5e-5°), which moved 512x512 white-noise frames by 3e-4 of their
unit scale (H100 run, PERF.md); and at N = 2048 the phase reaches ~360
cycles, where a float32 evaluation loses ~1e-4 rad.

``rotate_fft_exact_pruned`` and ``rotate_fft_small_plain`` are the plain
versions of the CUDA shear kernels H2 and H3 in
:mod:`vip_tpu_torch.ops.shear`.

``fourier_shift_batch`` is VIP's 'vip-fft' sub-pixel shift (pad to a
square even canvas, FFT phase ramp, crop) over a batch of frames, each
with its own shift; ``fourier_shift`` is a batch of one. vip_tpu also had
a host numpy twin, ``fourier_shift_np``, only so that its TPU would not
compile one program per canvas size; PyTorch runs eagerly, so the port
has none. ``cyclic_fourier_shift`` is scipy's 'ndimage-fourier' shift
(``fourier_shift`` of the ``fftn``, no pad: the frame wraps around), the
shift of NEGFC's PSF stamps, batched over any leading axes.
"""

import math

import torch

from ..config.device import as_tensor

__all__ = ["decompose_rotation", "quad_rot90", "fft_shear", "rotate_fft",
           "rotate_fft_exact_pruned", "rotate_fft_small_plain",
           "rotate_fft_fast_batch", "fourier_shift", "fourier_shift_batch",
           "cyclic_fourier_shift"]

# +1-pixel placement of a rot90'd even frame per quadrant k (the reference
# rot90s the (N+1)-extended canvas about its center)
_DY = (0, 1, 1, 0)
_DX = (0, 0, 1, 1)


def _complex_dtype(real_dtype):
    return torch.complex128 if real_dtype == torch.float64 \
        else torch.complex64


def _real_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def decompose_rotation(angles, real_dtype=torch.float32, device=None):
    """Quadrant reduction ``angle = 90*k + dangle`` with dangle in
    (-45, 45] (vip_tpu fft.py:46). Computed in ``real_dtype`` so that the
    quadrant boundaries fall as they do in vip_tpu at that precision.
    Returns (k, dangle): int64 and ``real_dtype`` tensors on ``device``
    (default: the device of ``angles``, or the CPU)."""
    if device is None and isinstance(angles, torch.Tensor):
        device = angles.device
    angles = torch.as_tensor(angles, dtype=real_dtype, device=device) % 360.0
    d = angles % 90.0
    dangle_gt = torch.where(d > 45.0, d - 90.0, d)
    use_rot = angles > 45.0
    k = torch.where(use_rot, torch.round(angles / 90.0),
                    torch.zeros_like(angles)).to(torch.int64) % 4
    return k, torch.where(use_rot, dangle_gt, angles)


def quad_rot90(k, frame):
    """rot90 of the last two axes by the quadrant count ``k`` (numpy's
    direction, as ``jnp.rot90``)."""
    return torch.rot90(frame, int(k), dims=(-2, -1))


def _place_quadrants(frames, k, out, row0, col0, shifted):
    """Write ``rot90(frames[i], k[i])`` into ``out[i]`` at (row0, col0),
    one pixel down/right per quadrant when ``shifted`` (the even-frame
    placement: k=1 +row, k=2 +row+col, k=3 +col). Returns ``out``."""
    y, x = frames.shape[-2:]
    for kk in range(4):
        sel = (k == kk).to(out.device)
        if not bool(sel.any()):
            continue
        r0 = row0 + (_DY[kk] if shifted else 0)
        c0 = col0 + (_DX[kk] if shifted else 0)
        out[sel, r0:r0 + y, c0:c0 + x] = torch.rot90(
            frames[sel], kk, dims=(1, 2)).to(out.dtype)
    return out


def _shear_coefs(angles, k, dangle):
    """The shear coefficients a = tan(θ/2) and b = −sin θ, in float64, of
    the residual angle θ of ``decompose_rotation``'s (k, dangle), which
    may have been computed in float32: θ is dangle plus the float64
    remainder of angle − 90k − dangle modulo 90 (its rounding error; the
    quadrant choice itself is kept)."""
    dg = dangle.to(torch.float64)
    r = (torch.as_tensor(angles, dtype=torch.float64, device=dg.device)
         - 90.0 * k.to(torch.float64) - dg)
    rad = torch.deg2rad(dg + (r - 90.0 * torch.round(r / 90.0)))
    return torch.tan(rad / 2), -torch.sin(rad)


def _shear_phase(c, q, N, dim, cdtype):
    """exp(−2πi·c·q·k/N) for per-frame coefficients ``c`` (B,), centered
    line coordinates ``q`` (L,) and the signed frequencies k of length N
    (``fftfreq``: −N/2 at index N/2). Shape (B, L, N) for row lines
    (``dim=2``), (B, N, L) for column lines (``dim=1``). Evaluated in
    float64, returned in ``cdtype``."""
    kint = torch.fft.fftfreq(N, d=1.0 / N, dtype=torch.float64,
                             device=q.device)
    q = q.to(torch.float64)
    ramp = torch.outer(q, kint) if dim == 2 else torch.outer(kint, q)
    cyc = c.to(torch.float64)[:, None, None] * (ramp / N)
    return torch.exp((-2j * math.pi) * cyc).to(cdtype)


def _shear_lines(z, c, q, dim):
    """Shear of complex (B, ., .) lines along ``dim``: DFT, phase ramp,
    inverse DFT."""
    N = z.shape[dim]
    s = torch.fft.fft(z, dim=dim)
    s = s * _shear_phase(c, q, N, dim, z.dtype)
    return torch.fft.ifft(s, dim=dim)


def fft_shear(arr, c, ax, phase=None):
    """One linear shear of an even square 2-d array (complex ok) as a 1-D
    FFT phase multiplication along ``ax`` (vip_tpu fft.py:74). ``phase`` is
    accepted and ignored, as in vip_tpu, whose shear builds its own phase
    ramp too."""
    N = arr.shape[0]
    real = _real_dtype(arr.real.dtype if arr.is_complex() else arr.dtype)
    z = arr.to(_complex_dtype(real))
    q = torch.arange(N, dtype=torch.float64, device=arr.device) - N / 2
    c = torch.as_tensor(c, dtype=torch.float64, device=arr.device).reshape(1)
    return _shear_lines(z[None], c, q, 2 if ax == 1 else 1)[0]


def rotate_fft(array, angle):
    """Rotate a square 2-d real tensor by ``angle`` degrees (counter-
    clockwise) with three FFT shears (vip_tpu fft.py:98). For even inputs
    the rotation center is (y/2, x/2), as in VIP."""
    y_ori = array.shape[0]
    if array.ndim != 2 or array.shape[0] != array.shape[1]:
        raise ValueError("rotate_fft expects a square 2d array")
    if array.is_complex():
        raise TypeError("rotate_fft expects a real array")
    real = _real_dtype(array.dtype)
    k, dangle = decompose_rotation(angle, real, array.device)

    odd = y_ori % 2
    if not odd:
        arr = array.new_zeros((y_ori + 1, y_ori + 1))
        arr[:-1, :-1] = array
    else:
        arr = array
    arr = quad_rot90(k, arr)[:-1, :-1]

    a, b = _shear_coefs(angle, k, dangle)
    s = fft_shear(arr, a, ax=1)
    s = fft_shear(s, b, ax=0)
    s = fft_shear(s, a, ax=1)
    out = s.real.to(array.dtype)
    if odd:
        res = array.new_zeros((y_ori, y_ori))
        res[:-1, :-1] = out
        return res
    return out


def rotate_fft_exact_pruned(frames, angles, pad_y, py0, px0, cy0, cy1,
                            cx0, cx1):
    """The 4x-padded three-shear rotation pipeline (pad → rotate_fft →
    crop) with support pruning (vip_tpu fft.py:150-226).

    Shear 1 runs only on the y+1 occupied rows, shear 3 only on the crop
    rows; only the middle y-shear needs full columns. Odd canvases (odd
    frames) rotate on the even (pad_y-1) leading sub-canvas with no +1
    placement shifts. ``frames``: (B, y, y) real; geometry ints from
    ``preproc.derotation._fft_rotate_geometry``. This is the plain
    version of ``ops.shear.rotate_fft_exact_fused``.
    """
    B, y, _ = frames.shape
    odd_canvas = pad_y % 2 == 1
    N = pad_y - 1 if odd_canvas else pad_y
    real = _real_dtype(frames.dtype)
    cdtype = _complex_dtype(real)
    dev = frames.device

    k, dangle = decompose_rotation(angles, real, dev)
    a, b = _shear_coefs(angles, k, dangle)
    q = torch.arange(N, dtype=torch.float64, device=dev) - N / 2

    # occupied slab: y+1 rows starting at py0 (room for the +1 shifts)
    slab = torch.zeros((B, y + 1, N), dtype=cdtype, device=dev)
    _place_quadrants(frames, k, slab, 0, px0, shifted=not odd_canvas)

    s = _shear_lines(slab, a, q[py0:py0 + y + 1], dim=2)        # shear 1
    canvas = torch.zeros((B, N, N), dtype=cdtype, device=dev)
    canvas[:, py0:py0 + y + 1] = s
    s = _shear_lines(canvas, b, q, dim=1)                        # shear 2
    s = _shear_lines(s[:, cy0:cy1], a, q[cy0:cy1], dim=2)        # shear 3
    return s[:, :, cx0:cx1].real.to(frames.dtype)


def rotate_fft_small_plain(cube, angles):
    """Rotate (B, N, N) even canvases by ``angles`` degrees about
    (N/2, N/2) with three unpacked complex FFT shears over the full canvas,
    the real part out: the plain version of ``ops.shear.
    rotate_fft_small_fused`` (vip_tpu's Pallas K3, pallas_shear.py:918).
    The quadrant rot90 is placed as in :func:`rotate_fft_fast_batch`.

    Unlike the packed ``rotate_fft_fast_batch`` it keeps each shear's
    imaginary part, as the kernel does (the oracle of
    tests/test_pallas_shear.py:67-88).
    """
    n, N, _ = cube.shape
    real = _real_dtype(cube.dtype)
    dev = cube.device
    k, dangle = decompose_rotation(angles, real, dev)
    ext = torch.zeros((n, N + 1, N + 1), dtype=real, device=dev)
    work = _place_quadrants(cube, k, ext, 0, 0, shifted=True)[:, :-1, :-1]
    a, b = _shear_coefs(angles, k, dangle)
    q = torch.arange(N, dtype=torch.float64, device=dev) - N / 2
    z = work.to(_complex_dtype(real))
    z = _shear_lines(z, a, q, dim=2)
    z = _shear_lines(z, b, q, dim=1)
    z = _shear_lines(z, a, q, dim=2)
    return z.real.to(cube.dtype)


def _packed_shear(z, c1, c2, ax, q0=None):
    """One FFT shear of a complex pack ``z = f1 + i f2`` of two real frame
    batches with per-frame coefficients c1/c2 (vip_tpu fft.py:385). The
    Hermitian split recovers each frame's spectrum so each gets its own
    phase; both ride one inverse FFT. ``q0`` is the coordinate of the
    first line when ``z`` is a slab cut out of a larger canvas."""
    N = z.shape[ax]
    M = z.shape[1 if ax == 2 else 2]
    q = torch.arange(M, dtype=torch.float64, device=z.device) + \
        (-M / 2 if q0 is None else q0)
    F = torch.fft.fft(z, dim=ax)
    Frev = torch.roll(torch.flip(F, dims=(ax,)), 1, dims=ax)
    F1 = 0.5 * (F + torch.conj(Frev))
    F2 = -0.5j * (F - torch.conj(Frev))
    ph1 = _shear_phase(c1, q, N, ax, z.dtype)
    ph2 = _shear_phase(c2, q, N, ax, z.dtype)
    return torch.fft.ifft(F1 * ph1 + 1j * (F2 * ph2), dim=ax)


def rotate_fft_fast_batch(cube, angles, support_rows=None):
    """Rotate a batch of even square real frames with packed, shift-free
    three-shear FFTs (the fft-small speed mode; vip_tpu fft.py:421).

    Two real frames ride one complex FFT and the imaginary residue of each
    shear is dropped at unpack. ``support_rows=(r0, h)`` prunes the two
    x-shears to the row slab [r0, r0+h); rows outside it come back zero.
    """
    n, N, _ = cube.shape
    real = _real_dtype(cube.dtype)
    dev = cube.device
    k, dangle = decompose_rotation(angles, real, dev)

    # rot90 about the (N/2, N/2) center of an even frame == rot90 of the
    # (N+1)x(N+1) zero-extended frame, cropped back
    ext = torch.zeros((n, N + 1, N + 1), dtype=real, device=dev)
    work = _place_quadrants(cube, k, ext, 0, 0, shifted=True)[:, :-1, :-1]

    a, b = _shear_coefs(angles, k, dangle)
    if n % 2:
        work = torch.cat([work, work.new_zeros((1, N, N))])
        a = torch.cat([a, a.new_zeros(1)])
        b = torch.cat([b, b.new_zeros(1)])
    z = torch.complex(work[0::2], work[1::2])
    a1, a2 = a[0::2], a[1::2]
    b1, b2 = b[0::2], b[1::2]

    if support_rows is None:
        z = _packed_shear(z, a1, a2, ax=2)
        z = _packed_shear(z, b1, b2, ax=1)
        z = _packed_shear(z, a1, a2, ax=2)
    else:
        r0, h = support_rows
        zs = _packed_shear(z[:, r0:r0 + h], a1, a2, ax=2, q0=r0 - N / 2)
        z = torch.zeros_like(z)
        z[:, r0:r0 + h] = zs
        z = _packed_shear(z, b1, b2, ax=1)
        zs = _packed_shear(z[:, r0:r0 + h], a1, a2, ax=2, q0=r0 - N / 2)
        z = torch.zeros_like(z)
        z[:, r0:r0 + h] = zs

    out = torch.empty((z.shape[0] * 2, N, N), dtype=real, device=dev)
    out[0::2] = z.real
    out[1::2] = z.imag
    return out[:n].to(cube.dtype)


def _frame_center_static(ny, nx):
    """The frame-center convention of ``var.coords.frame_center`` on
    ints."""
    return int(ny / 2 - 0.5 * (ny % 2)), int(nx / 2 - 0.5 * (nx % 2))


def _shift_geometry(ny, nx, npad):
    """The pad-to-square-even geometry of VIP's 'vip-fft' shift (vip_tpu
    fft.py:309-332): (even canvas side, frame row and column on it
    before the per-frame odd offset)."""
    cy_ori, cx_ori = _frame_center_static(ny, nx)
    new_y, new_x = ny + 2 * npad, nx + 2 * npad
    cy, cx = _frame_center_static(new_y, new_x)
    npix = max(new_y, new_x)
    sq_y0 = int(cx - cy) if new_x > new_y else 0
    sq_x0 = int(cy - cx) if new_y > new_x else 0
    npix_f = npix + npix % 2
    return (npix_f, npix % 2 == 1, sq_y0 + int(cy - cy_ori),
            sq_x0 + int(cx - cx_ori), npad + sq_y0, npad + sq_x0)


def fourier_shift_batch(cube, shifts_y, shifts_x, npad):
    """Shift each frame of a (B, ny, nx) batch by its own (shift_y,
    shift_x) pixels with an FFT phase ramp on a zero-padded square even
    canvas (vip_tpu fft.py:293 and :362, VIP recentering.py:126-189).

    ``npad`` is the pad margin, shared by the batch: VIP takes
    ``ceil(max|shift|)`` of each call. For an odd canvas each frame sits
    one pixel further along an axis whose shift is not positive, so the
    placement (and the crop) depends on the sign of each frame's own
    shift. Returns a tensor of the frames' dtype on their device (numpy
    input goes to the default device); the phase is evaluated in
    float64.
    """
    cube = as_tensor(cube)
    B, ny, nx = cube.shape
    real = _real_dtype(cube.dtype)
    dev = cube.device
    sy = torch.as_tensor(shifts_y, dtype=torch.float64).reshape(-1).expand(B)
    sx = torch.as_tensor(shifts_x, dtype=torch.float64).reshape(-1).expand(B)
    N, odd, y0, x0, p_y0, p_x0 = _shift_geometry(ny, nx, int(npad))
    off_y = (sy <= 0).long() if odd else torch.zeros(B, dtype=torch.long)
    off_x = (sx <= 0).long() if odd else torch.zeros(B, dtype=torch.long)

    canvas = torch.zeros((B, N, N), dtype=real, device=dev)
    groups = []
    for oy in (0, 1):
        for ox in (0, 1):
            sel = ((off_y == oy) & (off_x == ox)).to(dev)
            if bool(sel.any()):
                groups.append((sel, oy, ox))
                canvas[sel, y0 + oy:y0 + oy + ny, x0 + ox:x0 + ox + nx] = \
                    cube[sel].to(real)

    # the phase ramp exp(-2πi/N (sx·r_x + sy·r_y)), r = q - N/2, fftshifted
    # along both axes; it factors into one ramp along each axis
    r = torch.fft.fftshift(torch.arange(N, dtype=torch.float64) - N / 2)
    ph_y = torch.exp((-2j * math.pi / N) * sy[:, None] * r[None, :])
    ph_x = torch.exp((-2j * math.pi / N) * sx[:, None] * r[None, :])
    cdt = _complex_dtype(real)
    fact = (ph_y.to(dev, cdt)[:, :, None] * ph_x.to(dev, cdt)[:, None, :])
    shifted = torch.fft.ifft2(torch.fft.fft2(canvas) * fact).real

    out = torch.empty((B, ny, nx), dtype=cube.dtype if cube.is_floating_point()
                      else real, device=dev)
    for sel, oy, ox in groups:
        out[sel] = shifted[sel, p_y0 + oy:p_y0 + oy + ny,
                           p_x0 + ox:p_x0 + ox + nx].to(out.dtype)
    return out


def fourier_shift(array, shift_y, shift_x, npad):
    """Shift a 2-d frame by (shift_y, shift_x) pixels (vip_tpu
    fft.py:293): :func:`fourier_shift_batch` on a batch of one."""
    array = as_tensor(array)
    return fourier_shift_batch(array[None], [float(shift_y)],
                               [float(shift_x)], npad)[0]


def cyclic_fourier_shift(frame, dy, dx):
    """Cyclic (wrap-around) sub-pixel shift of the last two axes of
    ``frame`` by (dy, dx) pixels: ``ifftn(scipy.ndimage.fourier_shift(
    fftn(frame), (dy, dx))).real`` (vip_tpu negfc_model.py:32,
    recentering.py:44-48), with no pad.

    ``dy`` and ``dx`` are scalars or arrays whose shape broadcasts against
    the leading axes of ``frame``: a (W, n) array of shifts of one (s, s)
    stamp gives (W, n, s, s) stamps from one batched FFT. The phase is
    evaluated in float64 and cast to the working complex dtype. Returns a
    tensor on the frame's device (numpy input goes to the default
    device)."""
    frame = as_tensor(frame)
    ny, nx = frame.shape[-2:]
    dev = frame.device
    dy = torch.as_tensor(dy, dtype=torch.float64).to(dev)
    dx = torch.as_tensor(dx, dtype=torch.float64).to(dev)
    fy = torch.fft.fftfreq(ny, dtype=torch.float64, device=dev)[:, None]
    fx = torch.fft.fftfreq(nx, dtype=torch.float64, device=dev)[None, :]
    angle = (-2 * math.pi) * (dy[..., None, None] * fy
                              + dx[..., None, None] * fx)
    phase = torch.polar(torch.ones_like(angle), angle)
    spec = torch.fft.fft2(frame)
    return torch.fft.ifft2(spec * phase.to(spec.dtype)).real

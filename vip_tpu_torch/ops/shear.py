"""The exact FFT-shear rotation: CUDA kernel H2 and the port's one
rotation route.

H2 (``csrc/fft_shear.cu``) replaces vip_tpu's Pallas TPU kernel
``rotate_fft_exact_fused`` (vip_tpu/ops/pallas_shear.py:550-613): VIP's
4x-padded three-shear rotation of a batch of even square float32 frames,
as three launches (x-shear, y-shear, x-shear) with support pruning. The
quadrant rot90 and the +1-pixel placement run here in PyTorch; shear 1
reads only the occupied (y+1)-column band of the y+1 occupied rows, shear 2
writes only the crop rows, shear 3 writes only the crop columns and keeps
the real part. Between shears the intermediates are compact complex64
bands of (y+1) x N and (cy1-cy0) x N; the 4x canvas never exists.

Its plain version is ``ops.fft.rotate_fft_exact_pruned``.

:func:`rotate_exact` is the one route every exact rotation of the port
takes (``cube_derotate``, ``frame_rotate``, ``ops.pipeline``): H2 on a
CUDA float32 tensor whose shape passes :func:`fused_shear_supported`, the
plain version otherwise.
"""

import numpy as np
import torch

from .fft import (_place_quadrants, _shear_coefs, decompose_rotation,
                  rotate_fft_exact_pruned)

__all__ = ["fused_shear_supported", "rotate_fft_exact_fused",
           "rotate_exact"]

#: Number of H2 launches (three per rotated batch) since the last reset.
launches = 0

_twiddles = {}


def fused_shear_supported(y, pad_y, dtype=torch.float32, device="cuda"):
    """Gate of H2, a pure function of shape, dtype and device: even frame
    side ``y``, canvas ``N = pad_y`` a power of two with 128 <= N <= 4096
    (one line of N complex64 is at most 32 KB of shared memory), float32,
    CUDA. With ``_fft_rotate_geometry`` that is frames of 32, 64, 128,
    256, 512 and 1024 px; other canvases (N = 384, 640, ... need mixed
    radix) and odd frames take the plain version."""
    return (y % 2 == 0 and 128 <= pad_y <= 4096
            and pad_y & (pad_y - 1) == 0 and dtype == torch.float32
            and torch.device(device).type == "cuda")


def _twiddle_table(N, device):
    """exp(−2πi·t/N), t < N/2, built in float64 on the host, as complex64
    on ``device`` (cached per canvas and device)."""
    key = (N, str(device))
    if key not in _twiddles:
        t = np.exp(-2j * np.pi * np.arange(N // 2) / N).astype(np.complex64)
        _twiddles[key] = torch.from_numpy(t).to(device)
    return _twiddles[key]


def _shear(lib, src, dst, coef, tw, lines, N, q0, in_strides, in_len,
           in_off, out_strides, out_len, out_off):
    from .._build import check

    global launches
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = lib.vip_shear_lines(
        int(not src.is_complex()), int(not dst.is_complex()),
        src.data_ptr(), dst.data_ptr(), coef.data_ptr(), tw.data_ptr(),
        src.shape[0], lines, N, q0, *in_strides, in_len, in_off,
        *out_strides, out_len, out_off, stream)
    check(rc, "rotate_fft_exact_fused")
    launches += 1


def rotate_fft_exact_fused(frames, angles, pad_y, py0, px0, cy0, cy1, cx0,
                           cx1):
    """Rotate (B, y, y) frames by ``angles`` degrees with VIP's exact
    4x-padded three-shear rotation, geometry from
    ``preproc.derotation._fft_rotate_geometry``.

    CPU tensors take the plain version (``rotate_fft_exact_pruned``). CUDA
    tensors launch H2 and raise on anything it does not take: they must be
    contiguous float32 with :func:`fused_shear_supported` true.
    """
    if frames.device.type == "cpu":
        return rotate_fft_exact_pruned(frames, angles, pad_y, py0, px0, cy0,
                                       cy1, cx0, cx1)
    B, y, x = frames.shape
    N = pad_y
    if not (y == x and fused_shear_supported(y, N, frames.dtype,
                                             frames.device)):
        raise ValueError(f"rotate_fft_exact_fused: kernel takes even square "
                         f"float32 CUDA frames on a power-of-two canvas "
                         f"128..4096, got {frames.dtype} {tuple(frames.shape)}"
                         f" on {frames.device}, canvas {N}")
    if not frames.is_contiguous():
        raise ValueError("rotate_fft_exact_fused: frames must be contiguous")
    if B * max(y + 1, N) >= 2 ** 31:
        raise ValueError("rotate_fft_exact_fused: too many frames for one "
                         "launch grid")
    from .._build import load

    lib = load()
    dev = frames.device
    k, dangle = decompose_rotation(angles, torch.float32, dev)
    a, b = _shear_coefs(angles, k, dangle)    # float64, as the plain one
    tw = _twiddle_table(N, dev)
    R1, R2, W3 = y + 1, cy1 - cy0, cx1 - cx0

    # rot90 + placement into the occupied (y+1)^2 band: canvas rows
    # py0..py0+y, columns px0..px0+y
    slab = torch.zeros((B, R1, R1), dtype=torch.float32, device=dev)
    _place_quadrants(frames, k, slab, 0, 0, shifted=True)

    with torch.cuda.device(dev):
        # shear 1 (x) on the occupied rows: band in, full rows out
        s1 = torch.empty((B, R1, N), dtype=torch.complex64, device=dev)
        _shear(lib, slab, s1, a, tw, R1, N, py0, (R1 * R1, R1, 1), R1, px0,
               (R1 * N, N, 1), N, 0)
        # shear 2 (y) on every column: occupied rows in, crop rows out
        s2 = torch.empty((B, R2, N), dtype=torch.complex64, device=dev)
        _shear(lib, s1, s2, b, tw, N, N, 0, (R1 * N, 1, N), R1, py0,
               (R2 * N, 1, N), R2, cy0)
        # shear 3 (x) on the crop rows: full rows in, crop columns out
        out = torch.empty((B, R2, W3), dtype=torch.float32, device=dev)
        _shear(lib, s2, out, a, tw, R2, N, cy0, (R2 * N, N, 1), N, 0,
               (R2 * W3, W3, 1), W3, cx0)
    return out


def rotate_exact(frames, angles):
    """Rotate (B, y, y) real frames counter-clockwise by ``angles``
    degrees with VIP's exact 4x-padded FFT rotation: H2 where its gate
    holds on a CUDA float32 tensor, the plain ``torch.fft`` version
    otherwise (CPU tensors, float64, odd frames, mixed-radix canvases)."""
    from ..preproc.derotation import _fft_rotate_geometry

    B, y, x = frames.shape
    if y != x:
        raise ValueError("vip-fft rotation requires square frames")
    pad_y, _, py0, px0, cy0, cy1, cx0, cx1 = _fft_rotate_geometry(y, x)
    if fused_shear_supported(y, pad_y, frames.dtype, frames.device):
        return rotate_fft_exact_fused(frames.contiguous(), angles, pad_y,
                                      py0, px0, cy0, cy1, cx0, cx1)
    return rotate_fft_exact_pruned(frames, angles, pad_y, py0, px0, cy0,
                                   cy1, cx0, cx1)


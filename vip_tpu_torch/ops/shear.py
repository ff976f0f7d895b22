"""The FFT-shear rotations on the card: CUDA kernels H2, H3 and H4, and
the port's one exact rotation route.

All three run the mixed-radix line shear of ``csrc/shear_line.cuh``
(canvases N = p·2^m, p odd ≤ 15, 128 ≤ N ≤ 4096): H2 and H3 as three
launches of ``csrc/fft_shear.cu``, H4 as one cooperative launch of
``csrc/fft_shear3.cu``.

H2 replaces vip_tpu's Pallas TPU kernel ``rotate_fft_exact_fused``
(vip_tpu/ops/pallas_shear.py:550-613): VIP's 4x-padded three-shear
rotation of a batch of even square float32 frames, as three launches
(x-shear, y-shear, x-shear) with support pruning. The quadrant rot90 and
the +1-pixel placement run here in PyTorch; shear 1 reads only the occupied
(y+1)-column band of the y+1 occupied rows, shear 2 writes only the crop
rows, shear 3 writes only the crop columns and keeps the real part.
Between shears the intermediates are compact complex64 bands of (y+1) x N
and (cy1-cy0) x N; the 4x canvas never exists. Its plain version is
``ops.fft.rotate_fft_exact_pruned``.

H3 replaces ``rotate_fft_small_fused`` (vip_tpu/ops/pallas_shear.py:918):
the same three shears on a full, already padded N x N canvas, N = 128·P
with P ≤ 16 (the fft-small mode's canvas), with no pruning and the real
part out. Its plain version is ``ops.fft.rotate_fft_small_plain``.

H4 replaces ``_fused3_call`` (vip_tpu/ops/pallas_shear.py:694-842), reached
by ``rotate_fft_exact_fused3`` (:845) and ``rotate_fft_small_fused3``
(:890): the functions of H2 and H3 with all three shears in one
persistent cooperative launch whose grid walks the batch in groups of
frames; the complex intermediate band of a group stays in a scratch
buffer sized to fit the L2 cache (:func:`_fused3_group`). Same line
arithmetic, so the same plain versions.

:func:`rotate_exact` is the one route every exact rotation of the port
takes (``cube_derotate``, ``frame_rotate``, ``ops.pipeline``). It reads
``VIP_EXACT_SHEAR`` as vip_tpu does (vip_tpu/ops/pipeline.py:127-143):
"auto" (the default) or "fused" → H2, "fused3" → H4, on a CUDA float32
tensor whose shape passes :func:`fused_shear_supported`; "pruned", and
any tensor outside the gate, → the plain version.
``ops.pipeline._derotate_frames`` routes the fft-small mode to H3 (or H4
with ``VIP_SMALL_SHEAR=fused3``).
"""

import os

import numpy as np
import torch

from .fft import (_place_quadrants, _shear_coefs, decompose_rotation,
                  rotate_fft_exact_pruned, rotate_fft_small_plain)

__all__ = ["fused_shear_supported", "rotate_fft_exact_fused",
           "rotate_exact", "fused_small_supported",
           "rotate_fft_small_fused", "rotate_fft_exact_fused3",
           "rotate_fft_small_fused3"]

#: Number of H2 launches (three per rotated batch) since the last reset.
launches = 0
#: Number of H3 launches (three per rotated batch) since the last reset.
small_launches = 0
#: Number of H4 launches (one per rotated batch, exact or small) since the
#: last reset.
fused3_launches = 0

# scratch of one H4 launch: a few frames' intermediate bands, well inside
# the H100's 50 MB L2
_FUSED3_SCRATCH_BYTES = 40 << 20

_twiddles = {}


def _line_canvas_ok(N):
    """Canvases the line kernel takes: N = p·2^m, p odd ≤ 15,
    128 ≤ N ≤ 4096 (one line of N complex64 is at most 32 KB of shared
    memory)."""
    if not 128 <= N <= 4096:
        return False
    while N % 2 == 0:
        N //= 2
    return N <= 15


def fused_shear_supported(y, pad_y, dtype=torch.float32, device="cuda"):
    """Gate of H2, a pure function of shape, dtype and device: even frame
    side ``y``, canvas ``N = pad_y`` of the form p·2^m with p odd ≤ 15 and
    128 ≤ N ≤ 4096, float32, CUDA. With ``_fft_rotate_geometry`` that is
    every even frame of 32 to 480 px whose canvas is 128·P (96, 160, 192,
    224, 288, ... px) and 512 and 1024 px; odd frames take the plain
    version."""
    return (y % 2 == 0 and _line_canvas_ok(pad_y)
            and dtype == torch.float32
            and torch.device(device).type == "cuda")


def fused_small_supported(pad_to, dtype=torch.float32, device="cuda"):
    """Gate of H3, a pure function of shape, dtype and device: vip_tpu's
    canvas condition (``pad_to`` a multiple of 128 with pad_to/128 ≤ 16,
    vip_tpu/ops/pallas_shear.py:913-915), float32, CUDA."""
    return (pad_to > 0 and pad_to % 128 == 0 and pad_to // 128 <= 16
            and dtype == torch.float32
            and torch.device(device).type == "cuda")


def _twiddle_table(N, device):
    """exp(−2πi·t/N), t < N, built in float64 on the host, as complex64
    on ``device`` (cached per canvas and device)."""
    key = (N, str(device))
    if key not in _twiddles:
        t = np.exp(-2j * np.pi * np.arange(N) / N).astype(np.complex64)
        _twiddles[key] = torch.from_numpy(t).to(device)
    return _twiddles[key]


def _shear(lib, src, dst, coef, tw, lines, N, q0, in_strides, in_len,
           in_off, out_strides, out_len, out_off, what):
    """One launch of the line kernel; raises if it was refused."""
    from .._build import check

    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = lib.vip_shear_lines(
        int(not src.is_complex()), int(not dst.is_complex()),
        src.data_ptr(), dst.data_ptr(), coef.data_ptr(), tw.data_ptr(),
        src.shape[0], lines, N, q0, *in_strides, in_len, in_off,
        *out_strides, out_len, out_off, stream)
    check(rc, what)


def _exact_setup(frames, angles, pad_y, what):
    """Check (B, y, y) frames for the exact kernels (H2, H4) and prepare a
    launch: the library, the float64 shear coefficients (as the plain
    version's), the twiddle table and the rot90-placed frames in the
    occupied (y+1)² band of the canvas (rows py0..py0+y, columns
    px0..px0+y)."""
    B, y, x = frames.shape
    if not (y == x and fused_shear_supported(y, pad_y, frames.dtype,
                                             frames.device)):
        raise ValueError(f"{what}: kernel takes even square float32 CUDA "
                         f"frames on a canvas p·2^m (p odd <= 15) in "
                         f"128..4096, got {frames.dtype} "
                         f"{tuple(frames.shape)} on {frames.device}, canvas "
                         f"{pad_y}")
    if not frames.is_contiguous():
        raise ValueError(f"{what}: frames must be contiguous")
    from .._build import load

    dev = frames.device
    k, dangle = decompose_rotation(angles, torch.float32, dev)
    a, b = _shear_coefs(angles, k, dangle)
    slab = torch.zeros((B, y + 1, y + 1), dtype=torch.float32, device=dev)
    _place_quadrants(frames, k, slab, 0, 0, shifted=True)
    return load(), a, b, _twiddle_table(pad_y, dev), slab


def _small_setup(cube, angles, what):
    """Check (B, N, N) canvases for the small kernels (H3, H4) and prepare
    a launch: the library, the float64 shear coefficients, the twiddle
    table and the rot90-placed canvases. A rot90 about (N/2, N/2) is the
    rot90 of the (N+1)² zero-extended canvas, cropped back: the first
    shear reads the leading N x N of that canvas."""
    B, N, x = cube.shape
    if not (N == x and fused_small_supported(N, cube.dtype, cube.device)):
        raise ValueError(f"{what}: kernel takes square float32 CUDA "
                         f"canvases of 128·P px, P <= 16, got {cube.dtype} "
                         f"{tuple(cube.shape)} on {cube.device}")
    if not cube.is_contiguous():
        raise ValueError(f"{what}: cube must be contiguous")
    from .._build import load

    dev = cube.device
    k, dangle = decompose_rotation(angles, torch.float32, dev)
    a, b = _shear_coefs(angles, k, dangle)
    ext = torch.zeros((B, N + 1, N + 1), dtype=torch.float32, device=dev)
    _place_quadrants(cube, k, ext, 0, 0, shifted=True)
    return load(), a, b, _twiddle_table(N, dev), ext


def rotate_fft_exact_fused(frames, angles, pad_y, py0, px0, cy0, cy1, cx0,
                           cx1):
    """Rotate (B, y, y) frames by ``angles`` degrees with VIP's exact
    4x-padded three-shear rotation, geometry from
    ``preproc.derotation._fft_rotate_geometry``.

    CPU tensors take the plain version (``rotate_fft_exact_pruned``). CUDA
    tensors launch H2 and raise on anything it does not take: they must be
    contiguous float32 with :func:`fused_shear_supported` true.
    """
    global launches
    if frames.device.type == "cpu":
        return rotate_fft_exact_pruned(frames, angles, pad_y, py0, px0, cy0,
                                       cy1, cx0, cx1)
    B, y, _ = frames.shape
    N = pad_y
    if B * max(y + 1, N) >= 2 ** 31:
        raise ValueError("rotate_fft_exact_fused: too many frames for one "
                         "launch grid")
    lib, a, b, tw, slab = _exact_setup(frames, angles, N,
                                       "rotate_fft_exact_fused")
    dev = frames.device
    R1, R2, W3 = y + 1, cy1 - cy0, cx1 - cx0
    with torch.cuda.device(dev):
        # shear 1 (x) on the occupied rows: band in, full rows out
        s1 = torch.empty((B, R1, N), dtype=torch.complex64, device=dev)
        _shear(lib, slab, s1, a, tw, R1, N, py0, (R1 * R1, R1, 1), R1, px0,
               (R1 * N, N, 1), N, 0, "rotate_fft_exact_fused")
        launches += 1
        # shear 2 (y) on every column: occupied rows in, crop rows out
        s2 = torch.empty((B, R2, N), dtype=torch.complex64, device=dev)
        _shear(lib, s1, s2, b, tw, N, N, 0, (R1 * N, 1, N), R1, py0,
               (R2 * N, 1, N), R2, cy0, "rotate_fft_exact_fused")
        launches += 1
        # shear 3 (x) on the crop rows: full rows in, crop columns out
        out = torch.empty((B, R2, W3), dtype=torch.float32, device=dev)
        _shear(lib, s2, out, a, tw, R2, N, cy0, (R2 * N, N, 1), N, 0,
               (R2 * W3, W3, 1), W3, cx0, "rotate_fft_exact_fused")
        launches += 1
    return out


def rotate_fft_small_fused(cube, angles):
    """Rotate (B, N, N) already padded canvases by ``angles`` degrees
    about (N/2, N/2) with three full-canvas FFT shears, the real part out
    (vip_tpu pallas_shear.py:918; the fft-small mode's rotation).

    CPU tensors take the plain version (``rotate_fft_small_plain``). CUDA
    tensors launch H3 and raise on anything it does not take: they must be
    contiguous square float32 with :func:`fused_small_supported` true.
    """
    global small_launches
    if cube.device.type == "cpu":
        return rotate_fft_small_plain(cube, angles)
    B, N, _ = cube.shape
    if B * N >= 2 ** 31:
        raise ValueError("rotate_fft_small_fused: too many frames for one "
                         "launch grid")
    lib, a, b, tw, ext = _small_setup(cube, angles, "rotate_fft_small_fused")
    dev = cube.device
    E = N + 1
    with torch.cuda.device(dev):
        s1 = torch.empty((B, N, N), dtype=torch.complex64, device=dev)
        _shear(lib, ext, s1, a, tw, N, N, 0, (E * E, E, 1), N, 0,
               (N * N, N, 1), N, 0, "rotate_fft_small_fused")
        small_launches += 1
        s2 = torch.empty_like(s1)
        _shear(lib, s1, s2, b, tw, N, N, 0, (N * N, 1, N), N, 0,
               (N * N, 1, N), N, 0, "rotate_fft_small_fused")
        small_launches += 1
        out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
        _shear(lib, s2, out, a, tw, N, N, 0, (N * N, N, 1), N, 0,
               (N * N, N, 1), N, 0, "rotate_fft_small_fused")
        small_launches += 1
    return out


def _fused3_group(B, band_bytes):
    """Frames per group of an H4 launch: as many frames' intermediate
    bands (``band_bytes`` each) as fit the scratch budget, at least 1."""
    return int(max(1, min(B, _FUSED3_SCRATCH_BYTES // band_bytes)))


def _fused3(lib, slab, out, a, b, tw, N, W1, R1, py0, px0, R2, cy0, W3,
            cx0, what):
    """One H4 launch; allocates its scratch; raises if it was refused."""
    from .._build import check

    B = slab.shape[0]
    G = _fused3_group(B, R1 * N * 8)
    scratch = torch.empty((G, R1, N), dtype=torch.complex64,
                          device=slab.device)
    stream = torch.cuda.current_stream(slab.device).cuda_stream
    rc = lib.vip_shear3(slab.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                        a.data_ptr(), b.data_ptr(), tw.data_ptr(), B, G, N,
                        slab.stride(0), slab.stride(1), R1, W1, py0, px0, R2,
                        cy0, W3, cx0, stream)
    check(rc, what)


def rotate_fft_exact_fused3(frames, angles, pad_y, py0, px0, cy0, cy1, cx0,
                            cx1):
    """:func:`rotate_fft_exact_fused` with the three shears in one
    cooperative launch (H4; vip_tpu pallas_shear.py:845). Same function,
    same arguments.

    CPU tensors take the plain version (``rotate_fft_exact_pruned``). CUDA
    tensors launch H4 and raise on anything it does not take (H2's gate,
    :func:`fused_shear_supported`; contiguous frames).
    """
    global fused3_launches
    if frames.device.type == "cpu":
        return rotate_fft_exact_pruned(frames, angles, pad_y, py0, px0, cy0,
                                       cy1, cx0, cx1)
    B, y, _ = frames.shape
    lib, a, b, tw, slab = _exact_setup(frames, angles, pad_y,
                                       "rotate_fft_exact_fused3")
    dev = frames.device
    R1, R2, W3 = y + 1, cy1 - cy0, cx1 - cx0
    out = torch.empty((B, R2, W3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _fused3(lib, slab, out, a, b, tw, pad_y, R1, R1, py0, px0, R2, cy0,
                W3, cx0, "rotate_fft_exact_fused3")
    fused3_launches += 1
    return out


def rotate_fft_small_fused3(cube, angles):
    """:func:`rotate_fft_small_fused` with the three shears in one
    cooperative launch (H4; vip_tpu pallas_shear.py:890): full bands on
    the (N+1)²-extended canvas. Same function, same arguments.

    CPU tensors take the plain version (``rotate_fft_small_plain``). CUDA
    tensors launch H4 and raise on anything it does not take (H3's gate,
    :func:`fused_small_supported`; contiguous square canvases).
    """
    global fused3_launches
    if cube.device.type == "cpu":
        return rotate_fft_small_plain(cube, angles)
    B, N, _ = cube.shape
    lib, a, b, tw, ext = _small_setup(cube, angles,
                                      "rotate_fft_small_fused3")
    dev = cube.device
    out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _fused3(lib, ext, out, a, b, tw, N, N, N, 0, 0, N, 0, N, 0,
                "rotate_fft_small_fused3")
    fused3_launches += 1
    return out


def _exact_shear_mode():
    """``VIP_EXACT_SHEAR`` as vip_tpu reads it (ops/pipeline.py:127):
    "auto" (default) and "fused" → H2, "fused3" → H4, "pruned" → the
    plain version."""
    return os.environ.get("VIP_EXACT_SHEAR", "auto")


def rotate_exact(frames, angles):
    """Rotate (B, y, y) real frames counter-clockwise by ``angles``
    degrees with VIP's exact 4x-padded FFT rotation: H2 (or H4 under
    ``VIP_EXACT_SHEAR=fused3``) where the gate holds on a CUDA float32
    tensor, the plain ``torch.fft`` version otherwise (CPU tensors,
    float64, odd frames, canvases outside the kernels' range, and
    ``VIP_EXACT_SHEAR=pruned``)."""
    from ..preproc.derotation import _fft_rotate_geometry

    B, y, x = frames.shape
    if y != x:
        raise ValueError("vip-fft rotation requires square frames")
    pad_y, _, py0, px0, cy0, cy1, cx0, cx1 = _fft_rotate_geometry(y, x)
    mode = _exact_shear_mode()
    if mode != "pruned" and fused_shear_supported(y, pad_y, frames.dtype,
                                                  frames.device):
        fn = rotate_fft_exact_fused3 if mode == "fused3" \
            else rotate_fft_exact_fused
        return fn(frames.contiguous(), angles, pad_y, py0, px0, cy0, cy1,
                  cx0, cx1)
    return rotate_fft_exact_pruned(frames, angles, pad_y, py0, px0, cy0,
                                   cy1, cx0, cx1)


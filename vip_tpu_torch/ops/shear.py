"""The FFT-shear rotations on the card: CUDA kernels H2, H3 and H4, and
the port's one exact rotation route.

All three shear lines of canvases N = p·2^m, p odd ≤ 15, 128 ≤ N ≤ 4096.
H2 and H3 are three launches of ``csrc/fft_shear.cu`` (x-shear, y-shear,
x-shear), which runs one of two line engines, chosen by N alone
(:func:`register_engine_takes`): up to N = 2048 the register-resident
engine of ``csrc/shear_regs.cuh`` (16 points a thread, radix-16 passes in
registers, shared memory only between passes, several lines a block, the
y-shear's columns in groups that read whole 32-byte sectors; its plan,
pass twiddles and slot → frequency table are built here:
:func:`_line_plan`, :func:`_pass_twiddles`, :func:`_freq_table`); above,
the radix-2 body ``vip::shear_line`` of ``csrc/shear_line.cuh``. H4 is
one cooperative launch of ``csrc/fft_shear3.cu`` (and, for N ≤ 2048,
``csrc/shear3_regs.cuh``) that runs the same engine as H2 and H3 on each
canvas, with the same tables and coefficients, line for line.

H2 replaces vip_tpu's Pallas TPU kernel ``rotate_fft_exact_fused``
(vip_tpu/ops/pallas_shear.py:550-613): VIP's 4x-padded three-shear
rotation of a batch of even square float32 frames, as three launches
(x-shear, y-shear, x-shear) with support pruning. Shear 1 reads each
frame's quadrant rot90, with the +1-pixel placement, in place from the
frames (the quadrants are computed here, the placed frames never exist)
and only the occupied (y+1)-column
band of the y+1 occupied rows, shear 2 writes only the crop rows, shear 3
writes only the crop columns and keeps the real part.
Between shears the intermediates are compact complex64 bands of (y+1) x N
and (cy1-cy0) x N; the 4x canvas never exists. Its plain version is
``ops.fft.rotate_fft_exact_pruned``.

H3 replaces ``rotate_fft_small_fused`` (vip_tpu/ops/pallas_shear.py:918):
the same three shears on a full, already padded N x N canvas, N = 128·P
with P ≤ 16 (the fft-small mode's canvas), with no pruning and the real
part out; shear 1 reads the rot90 in place, as H2's. Its plain version is
``ops.fft.rotate_fft_small_plain``.

H4 replaces ``_fused3_call`` (vip_tpu/ops/pallas_shear.py:694-842), reached
by ``rotate_fft_exact_fused3`` (:845) and ``rotate_fft_small_fused3``
(:890): the functions of H2 and H3 with all three shears in one
persistent cooperative launch whose grid walks the batch in groups of
frames; the complex intermediate band of a group stays in a scratch
buffer (:func:`_fused3_group`; a whole chunk by default), the y-shear
writes its crop rows in place there, and the first shear reads the
frames' rot90 in place as H2's and H3's do. The same functions, so the
same plain versions.

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

from ..config.timing import leading_frames, traced
from .fft import (_shear_coefs, decompose_rotation, rotate_fft_exact_pruned,
                  rotate_fft_small_plain)

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

# scratch of one H4 launch: the intermediate bands of a whole pipeline
# chunk (50 frames of 512² on N = 2048, 420 MB; 125 on 640², 410 MB). An
# L2-sized scratch (40 MB, four 512² frames a group) measured slower on the
# H100: each group's three stages start and end on a grid barrier, and few
# block iterations a stage leave most of that time to the ramps (PERF.md)
_FUSED3_SCRATCH_BYTES = 512 << 20

_twiddles = {}

# the register engine: points a thread holds, largest canvas
_REG_POINTS = 16
_REG_MAX_N = 2048


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
    128 ≤ N ≤ 4096, float32, CUDA. With ``_fft_rotate_geometry`` (N = 4y)
    that is every even frame of 32 to 1024 px whose 4y has that form (32,
    36, 40, ..., 64, 72, 80, ..., 128, 144, ..., 512, 576, ..., 1024 px);
    odd frames take the plain version. Which line engine a launch runs is
    a function of N alone (:func:`register_engine_takes`): the register
    engine up to N = 2048 (frames up to 512 px), the radix-2 body above
    (frames of 576 to 1024 px)."""
    return (y % 2 == 0 and _line_canvas_ok(pad_y)
            and dtype == torch.float32
            and torch.device(device).type == "cuda")


def fused_small_supported(pad_to, dtype=torch.float32, device="cuda"):
    """Gate of H3, a pure function of shape, dtype and device: vip_tpu's
    canvas condition (``pad_to`` a multiple of 128 with pad_to/128 ≤ 16,
    vip_tpu/ops/pallas_shear.py:913-915), float32, CUDA. Every such
    canvas (N ≤ 2048) runs the register engine."""
    return (pad_to > 0 and pad_to % 128 == 0 and pad_to // 128 <= 16
            and dtype == torch.float32
            and torch.device(device).type == "cuda")


def register_engine_takes(N):
    """Which line engine H2 and H3 run on a canvas of N points, a pure
    function of N: the register-resident engine of ``csrc/shear_regs.cuh``
    for every canvas of the gates up to N = 2048 (frames up to 512 px for
    H2, every fft-small canvas for H3), the radix-2 body
    ``vip::shear_line`` of ``csrc/shear_line.cuh`` above (2304 ≤ N ≤ 4096:
    frames of 576 to 1024 px)."""
    return _line_canvas_ok(N) and N <= _REG_MAX_N


def _line_plan(N):
    """The register engine's passes on a canvas of N = p·2^m points: a
    p-point pass first when p > 1, then radix 16 while 16 divides what is
    left, then the remaining 2, 4 or 8 (``csrc/shear_regs.cuh``,
    ``pow2_log_radix``). 2048 → [16, 16, 8], 640 → [5, 16, 8]."""
    p, m = N, 0
    while p % 2 == 0:
        p //= 2
        m += 1
    plan = [p] if p > 1 else []
    plan += [16] * (m // 4)
    if m % 4:
        plan.append(2 ** (m % 4))
    return plan


def _freq_table(N):
    """Slot → signed frequency of the register engine's forward result
    (int32, −N/2..N/2−1, numpy's fftfreq order of values): pass i writes
    its output digit d_i to the point d_i·L_i + ... (L_i = N / (R_0 ⋯
    R_i)), which holds frequency Σ d_i·R_0 ⋯ R_(i−1)."""
    pos = np.arange(N)
    k = np.zeros(N, dtype=np.int64)
    span, weight = N, 1
    for R in _line_plan(N):
        span //= R
        k += (pos // span) % R * weight
        weight *= R
    return np.where(k >= N // 2, k - N, k).astype(np.int32)


def _pass_twiddles(N):
    """The register engine's pass twiddle table (complex128): for each
    pass i of :func:`_line_plan`, in order, a block of S_i entries (S_i =
    N / (R_0 ⋯ R_(i−1)), the pass's sub-block size, L_i = S_i / R_i its
    span) holding W_(S_i)^(n'·k) = exp(−2πi·n'·k/S_i) at k·L_i + n'."""
    blocks, S = [], N
    for R in _line_plan(N):
        L = S // R
        blocks.append(np.exp(-2j * np.pi * np.outer(np.arange(R),
                                                    np.arange(L)) / S))
        S = L
    return np.concatenate([b.ravel() for b in blocks])


def _line_group(N, columns):
    """Lines a block of the register engine shears, T = N/16 threads each:
    rows, ⌈256/T⌉ (256 threads or a little more); columns, a multiple of
    4 adjacent columns, 4·max(1, ⌊64/T⌋) (thread c + C·t holds column c
    from row t, so a warp's accesses cover whole 32-byte sectors)."""
    T = N // _REG_POINTS
    return 4 * max(1, 64 // T) if columns else -(-256 // T)


def _line_tables(N, device):
    """The line kernels' tables on ``device``, built in float64 on the
    host and cached per canvas and device: the twiddles exp(−2πi·t/N),
    t < N, as complex64; for a canvas of the register engine also its pass
    twiddles (:func:`_pass_twiddles`, complex64) and its frequency table
    (:func:`_freq_table`, int32), else None for both."""
    key = (N, str(device))
    if key not in _twiddles:
        tw = np.exp(-2j * np.pi * np.arange(N) / N).astype(np.complex64)
        ptw = freq = None
        if register_engine_takes(N):
            ptw = torch.from_numpy(
                _pass_twiddles(N).astype(np.complex64)).to(device)
            freq = torch.from_numpy(_freq_table(N)).to(device)
        _twiddles[key] = (torch.from_numpy(tw).to(device), ptw, freq)
    return _twiddles[key]


def _shear(lib, src, dst, coef, tables, lines, N, q0, in_strides, in_len,
           in_off, out_strides, out_len, out_off, what, quad=None):
    """One launch of the line kernel (rows if the point stride is 1, else
    columns); raises if it was refused. A real ``src`` is the frames
    themselves, in_len² each, read as the rot90 of quadrant ``quad[b]``
    placed one pixel down/right as ``_place_quadrants(..., shifted=True)``
    places it (``csrc/shear_regs.cuh``, ``rot90_row``)."""
    from .._build import check

    tw, ptw, freq = tables
    group = _line_group(N, columns=in_strides[2] != 1)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = lib.vip_shear_lines(
        int(not src.is_complex()), int(not dst.is_complex()),
        src.data_ptr(), dst.data_ptr(), coef.data_ptr(), tw.data_ptr(),
        None if ptw is None else ptw.data_ptr(),
        None if freq is None else freq.data_ptr(),
        None if quad is None else quad.data_ptr(), src.shape[0], lines,
        group, N, q0, *in_strides, in_len, in_off, *out_strides, out_len,
        out_off, stream)
    check(rc, what)


@traced("derotation.shear_setup", leading_frames)
def _exact_setup(frames, angles, pad_y, what):
    """Check (B, y, y) frames for the exact kernels (H2, H4) and prepare a
    launch: the library, the float64 shear coefficients (as the plain
    version's), the line tables (:func:`_line_tables`) and the quadrants k
    of the rot90s (int64, on the card)."""
    _, y, x = frames.shape
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
    return load(), a, b, _line_tables(pad_y, dev), k


@traced("derotation.shear_setup", leading_frames)
def _small_setup(cube, angles, what):
    """Check (B, N, N) canvases for the small kernels (H3, H4) and prepare
    a launch: the library, the float64 shear coefficients, the line
    tables (:func:`_line_tables`) and the quadrants k of the rot90s. A
    rot90 about (N/2, N/2) is the rot90 of the (N+1)² zero-extended
    canvas, cropped back: the first shear reads the leading N x N of that
    canvas."""
    _, N, x = cube.shape
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
    return load(), a, b, _line_tables(N, dev), k


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
    lib, a, b, tables, k = _exact_setup(frames, angles, N,
                                        "rotate_fft_exact_fused")
    dev = frames.device
    R1, R2, W3 = y + 1, cy1 - cy0, cx1 - cx0
    with torch.cuda.device(dev):
        # shear 1 (x) on the occupied rows: the rot90-placed frames in
        # (read in place), full rows out
        s1 = torch.empty((B, R1, N), dtype=torch.complex64, device=dev)
        _shear(lib, frames, s1, a, tables, R1, N, py0, (y * y, y, 1), y,
               px0, (R1 * N, N, 1), N, 0, "rotate_fft_exact_fused", quad=k)
        launches += 1
        # shear 2 (y) on every column: occupied rows in, crop rows out
        s2 = torch.empty((B, R2, N), dtype=torch.complex64, device=dev)
        _shear(lib, s1, s2, b, tables, N, N, 0, (R1 * N, 1, N), R1, py0,
               (R2 * N, 1, N), R2, cy0, "rotate_fft_exact_fused")
        launches += 1
        # shear 3 (x) on the crop rows: full rows in, crop columns out
        out = torch.empty((B, R2, W3), dtype=torch.float32, device=dev)
        _shear(lib, s2, out, a, tables, R2, N, cy0, (R2 * N, N, 1), N, 0,
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
    lib, a, b, tables, k = _small_setup(cube, angles,
                                        "rotate_fft_small_fused")
    dev = cube.device
    with torch.cuda.device(dev):
        s1 = torch.empty((B, N, N), dtype=torch.complex64, device=dev)
        _shear(lib, cube, s1, a, tables, N, N, 0, (N * N, N, 1), N, 0,
               (N * N, N, 1), N, 0, "rotate_fft_small_fused", quad=k)
        small_launches += 1
        s2 = torch.empty_like(s1)
        _shear(lib, s1, s2, b, tables, N, N, 0, (N * N, 1, N), N, 0,
               (N * N, 1, N), N, 0, "rotate_fft_small_fused")
        small_launches += 1
        out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
        _shear(lib, s2, out, a, tables, N, N, 0, (N * N, N, 1), N, 0,
               (N * N, N, 1), N, 0, "rotate_fft_small_fused")
        small_launches += 1
    return out


def _fused3_group(B, band_bytes):
    """Frames per group of an H4 launch: as many frames' intermediate
    bands (``band_bytes`` each) as fit the scratch budget, at least 1."""
    return int(max(1, min(B, _FUSED3_SCRATCH_BYTES // band_bytes)))


def _fused3(lib, frames, quad, out, a, b, tables, N, R1, py0, px0, R2, cy0,
            W3, cx0, what, stamps=None, G=None):
    """One H4 launch on (B, y, y) frames, read in place as the rot90 of
    quadrant ``quad[b]``; allocates its scratch for G frames a group
    (default :func:`_fused3_group`); raises if it was refused. ``stamps``,
    an int64 tensor of 1 + 3·⌈B/G⌉ entries, gets block 0's %globaltimer
    (ns) at the start and after each grid barrier."""
    from .._build import check

    tw, ptw, freq = tables
    B, y = frames.shape[0], frames.shape[-1]
    G = _fused3_group(B, R1 * N * 8) if G is None else G
    scratch = torch.empty((G, R1, N), dtype=torch.complex64,
                          device=frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    rc = lib.vip_shear3(
        frames.data_ptr(), quad.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), a.data_ptr(), b.data_ptr(), tw.data_ptr(),
        None if ptw is None else ptw.data_ptr(),
        None if freq is None else freq.data_ptr(), B, G,
        _line_group(N, columns=True), N, y, R1, py0, px0, R2, cy0, W3, cx0,
        None if stamps is None else stamps.data_ptr(), stream)
    check(rc, what)


def fused3_config(N):
    """H4's launch configuration on a canvas of N points, from the card
    without a launch: registers and spilled bytes a thread, blocks an SM,
    the grid, threads and dynamic shared memory a block."""
    import ctypes

    from .._build import check, load

    info = (ctypes.c_int * 6)()
    check(load().vip_shear3_info(N, _line_group(N, columns=True), info),
          "fused3_config")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm", "grid",
                     "threads", "smem_bytes"), info))


def rotate_fft_exact_fused3(frames, angles, pad_y, py0, px0, cy0, cy1, cx0,
                            cx1):
    """:func:`rotate_fft_exact_fused` with the three shears in one
    cooperative launch (H4; vip_tpu pallas_shear.py:845). Same function,
    same arguments; the first shear reads each frame's rot90 in place, as
    H2's.

    CPU tensors take the plain version (``rotate_fft_exact_pruned``). CUDA
    tensors launch H4 and raise on anything it does not take (H2's gate,
    :func:`fused_shear_supported`; contiguous frames).
    """
    global fused3_launches
    if frames.device.type == "cpu":
        return rotate_fft_exact_pruned(frames, angles, pad_y, py0, px0, cy0,
                                       cy1, cx0, cx1)
    B, y, _ = frames.shape
    lib, a, b, tables, k = _exact_setup(frames, angles, pad_y,
                                        "rotate_fft_exact_fused3")
    dev = frames.device
    R2, W3 = cy1 - cy0, cx1 - cx0
    out = torch.empty((B, R2, W3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _fused3(lib, frames, k, out, a, b, tables, pad_y, y + 1, py0, px0,
                R2, cy0, W3, cx0, "rotate_fft_exact_fused3")
    fused3_launches += 1
    return out


def rotate_fft_small_fused3(cube, angles):
    """:func:`rotate_fft_small_fused` with the three shears in one
    cooperative launch (H4; vip_tpu pallas_shear.py:890): full bands on
    the N x N canvas, its rot90 read in place as H3's first shear reads it
    (the turn of the (N+1)²-extended canvas, cut back to N x N). Same
    function, same arguments.

    CPU tensors take the plain version (``rotate_fft_small_plain``). CUDA
    tensors launch H4 and raise on anything it does not take (H3's gate,
    :func:`fused_small_supported`; contiguous square canvases).
    """
    global fused3_launches
    if cube.device.type == "cpu":
        return rotate_fft_small_plain(cube, angles)
    B, N, _ = cube.shape
    lib, a, b, tables, k = _small_setup(cube, angles,
                                        "rotate_fft_small_fused3")
    dev = cube.device
    out = torch.empty((B, N, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _fused3(lib, cube, k, out, a, b, tables, N, N, 0, 0, N, 0, N, 0,
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


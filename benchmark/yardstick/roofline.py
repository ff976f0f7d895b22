"""The chip's peaks and the least work of each measured layer.

Frozen with the benchmark, so that a change to the program cannot change
the yardstick. ``bound_s`` and ``shear_flop`` are the arithmetic of
``chip_smoke.py``'s ``_bound`` and ``_shear_flop``; ``vip_fft_canvas`` is
the padding geometry of VIP's exact 'vip-fft' rotation (a ~1.5x
parity-preserving canvas, then ~4x), written again here from VIP's
``frame_rotate`` so that nothing of the program is read.
"""

import math

# One H100 SXM at 700 W, NVIDIA's data sheet: float32 outside the tensor
# cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes, flop):
    """The least time the chip needs, in seconds: the larger of the bytes
    over the memory rate and the float32 operations over the peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flop / PEAK_F32_FLOPS)


def shear_flop(lines, N):
    """Float32 operations of ``lines`` FFT line shears on an N canvas: a
    forward and an inverse complex FFT (5·N·log2 N each) and the phase
    product (6·N)."""
    return lines * (2 * 5 * N * math.log2(N) + 6 * N)


def _parity_pad(size, fac):
    new = int(size * fac)
    return new + 1 if new % 2 != size % 2 else new


def vip_fft_canvas(y):
    """(N, p0): the side of the zero canvas on which VIP's 'vip-fft'
    rotation shears an even y x y frame, and the row (and column) at which
    the frame sits in it and is cropped back out."""
    if y % 2:
        raise ValueError(f"even frames only, got {y}")
    mid = _parity_pad(y, 1.5)
    N = int(round(mid * (4 / 1.5)))
    if N % 2 != mid % 2:
        N -= 1
    return N, N // 2 - y // 2


def derotation_work(n, y):
    """(bytes, operations) of the exact three-shear rotation of n frames
    of y x y float32: each frame read once and written once; the first
    x-shear on the y + 1 rows the frame occupies, the y-shear on all N
    columns, the last x-shear on the y rows cropped back."""
    N, _ = vip_fft_canvas(y)
    return 2 * n * y * y * 4, shear_flop(n * (y + 1 + N + y), N)


def collapse_bytes(in_numel, out_numel, itemsize=4):
    """Bytes of a collapse: its input read once, its output written once."""
    return (in_numel + out_numel) * itemsize

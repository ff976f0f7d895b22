"""The host side of the register line engine of H2 and H3
(csrc/shear_regs.cuh), on the CPU: the radix plan, the slot → frequency
table and the pass twiddle table that ``ops.shear`` builds for the kernel,
and the y-shear's column-group layout.

For every canvas the gates accept (N = p·2^m, p odd ≤ 15, 128 ≤ N ≤
4096; the kernel runs the plan on those up to 2048,
``shear.register_engine_takes``, the radix-2 body above):
- the frequency table is a permutation of the signed frequencies
  −N/2..N/2−1;
- a numpy emulation of the plan's passes, reading the kernel's twiddles at
  the kernel's indices (the pass table by offset, k·L + n'; W_p^j from the
  twiddle table at M·j), ends in the table's order equal to
  ``numpy.fft.fft`` of a seeded random line within 1e-12 (float64; the
  same float64 sums in another order, ~1e-14 measured);
- shearing through the table (forward emulation, the phase of each slot's
  frequency, the mirrored inverse) gives ``ops.fft``'s plain line shear
  within 1e-12;
- every warp load of the y-shear's first pass covers whole 32-byte
  sectors, by index arithmetic on the launch layout ``ops.shear`` passes
  (the engine's canvases);
- the first x-shear's in-place read of each frame's rot90 gives the plain
  versions' placement.

The kernel itself against its plain version on a card:
tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

import vip_tpu_torch

from vip_tpu_torch.ops import fft, shear


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


F64_TOL = 1e-12

# every canvas the gates accept: N = p·2^m, p odd <= 15, 128 <= N <= 4096
GATE_CANVASES = sorted(p << m for p in range(1, 16, 2) for m in range(13)
                       if 128 <= p << m <= 4096)
ENGINE_CANVASES = [N for N in GATE_CANVASES if N <= 2048]


def _odd_part(N):
    p, m = N, 0
    while p % 2 == 0:
        p //= 2
        m += 1
    return p, m


def _emulate(x, N, inverse=False):
    """The engine's passes on a float64 line (numpy, vectorised over the
    butterflies). Forward: pass i views the line as sub-blocks of S_i
    points, [blk, j, n'] with point blk·S_i + j·L_i + n', forms each
    butterfly's R_i-point DFT and multiplies output k by the pass table's
    entry off_i + k·L_i + n'. Inverse: the passes backwards, each the
    conjugate twiddle, then the conjugate DFT (no 1/N)."""
    p, m = _odd_part(N)
    M = 1 << m
    plan = shear._line_plan(N)
    ptw = shear._pass_twiddles(N)
    tw = np.exp(-2j * np.pi * np.arange(N) / N)
    passes, S, off = [], N, 0
    for R in plan:
        L = S // R
        n = np.arange(R)
        if R == p and p > 1:        # W_p^j read at tw[M*j], as the kernel
            W = tw[M * (np.outer(n, n) % R)]
        else:
            W = np.exp(-2j * np.pi * np.outer(n, n) / R)
        passes.append((R, L, S, W, ptw[off:off + S].reshape(R, L)))
        off += S
        S = L
    y = np.asarray(x, dtype=np.complex128).copy()
    for R, L, S, W, t in (reversed(passes) if inverse else passes):
        blk = y.reshape(N // S, R, L)
        if inverse:
            blk = np.einsum("kn,bkl->bnl", W.conj(), blk * t.conj()[None])
        else:
            blk = np.einsum("kn,bnl->bkl", W, blk) * t[None]
        y = blk.reshape(N)
    return y


def test_gate_canvases_and_route():
    """The canvas list is the gates' own, and the engine is a pure
    function of N: every gate canvas up to 2048, none above or outside."""
    assert all(shear._line_canvas_ok(N) for N in GATE_CANVASES)
    assert len(GATE_CANVASES) == 41 and len(ENGINE_CANVASES) == 33
    for N in range(100, 4200):
        assert shear.register_engine_takes(N) == (
            shear._line_canvas_ok(N) and N <= 2048)
    for P in range(1, 17):
        assert shear.register_engine_takes(128 * P)   # every H3 canvas


@pytest.mark.parametrize("N", GATE_CANVASES)
def test_plan_and_frequency_table(N):
    """The plan multiplies to N with at most 4 passes (so at most 3
    shared-memory exchanges each way; 2 at N = 2048, 1024 and 640), and
    the table is a permutation of the signed frequencies."""
    plan = shear._line_plan(N)
    p, m = _odd_part(N)
    assert math.prod(plan) == N
    assert plan[0] == p if p > 1 else plan[0] == 16
    assert all(R in (2, 4, 8, 16) for R in plan[1 if p > 1 else 0:])
    assert len(plan) <= 4
    if N in (2048, 1024, 640):
        assert len(plan) == 3
    freq = shear._freq_table(N)
    assert freq.dtype == np.int32 and freq.shape == (N,)
    assert np.array_equal(np.sort(freq), np.arange(-N // 2, N // 2))


@pytest.mark.parametrize("N", GATE_CANVASES)
def test_emulated_passes_equal_numpy_fft(N):
    rng = np.random.default_rng(N)
    x = np.array([1.0, 1j]) @ rng.standard_normal((2, N))
    got = _emulate(x, N)
    ref = np.fft.fft(x)[shear._freq_table(N) % N]
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= F64_TOL * scale
    # the mirrored inverse undoes it (times N)
    back = _emulate(got, N, inverse=True) / N
    assert np.abs(back - x).max() <= F64_TOL * max(np.abs(x).max(), 1.0)


@pytest.mark.parametrize("N", GATE_CANVASES)
def test_shear_through_table_is_the_plain_line_shear(N):
    """The kernel's steps 2-4 on one line: forward passes, the phase
    exp(−2πi·c·(q − N/2)·k/N) of each slot's frequency k (the cycle
    count reduced in float64, as the kernel does before sincospif), inverse
    passes and 1/N, against ``ops.fft._shear_lines`` in complex128."""
    rng = np.random.default_rng(7 + N)
    x = np.array([1.0, 1j]) @ rng.standard_normal((2, N))
    c, q = -0.7071067811865475, N // 3
    k = shear._freq_table(N).astype(np.float64)
    cyc = c * (q - N // 2) * k / N
    cyc -= np.rint(cyc)
    got = _emulate(_emulate(x, N) * np.exp(-2j * np.pi * cyc), N,
                   inverse=True) / N
    ref = fft._shear_lines(torch.from_numpy(x)[None, None],
                           torch.tensor([c], dtype=torch.float64),
                           torch.tensor([q - N / 2], dtype=torch.float64),
                           dim=2)[0, 0].numpy()
    assert np.abs(got - ref).max() <= F64_TOL * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("N", ENGINE_CANVASES)
def test_column_group_loads_cover_whole_sectors(N):
    """The y-shear (complex64 columns of a row-major (rows, N) band):
    block g shears columns g·C .. g·C + C − 1, thread c + C·t holds
    column c from row t, and its first-pass load (u, j) reads row
    j·L0 + t + T·u (L0 = N / R0) where that row lies in the band. For
    every warp and
    every load instruction, each 32-byte sector it touches is read whole
    (4 complex64 by 4 threads); the stores of the last inverse pass use
    the same points."""
    p, _ = _odd_part(N)
    T = N // 16
    C = shear._line_group(N, columns=True)
    assert C >= 4 and C % 4 == 0 and C * T <= 512
    assert -(-256 // T) * T <= 512       # the row blocks
    R0 = p if p > 1 else 16
    L0, U0 = N // R0, -(-16 // R0)
    band = (N // 7, N // 3)              # in_off, in_len: whole rows drop
    tid = np.arange(C * T)
    c, t = tid % C, tid // C
    for g in (0, 1, N // C - 1):
        col = g * C + c
        for u in range(U0):
            beta = t + T * u
            for j in range(R0):
                row = j * L0 + beta
                active = (beta < L0) & (row >= band[0]) \
                    & (row < band[0] + band[1]) & (col < N)
                addr = (row * N + col) * 8
                for w in range(0, C * T, 32):
                    a = addr[w:w + 32][active[w:w + 32]]
                    if a.size == 0:
                        continue
                    assert np.unique(a).size == a.size
                    _, per_sector = np.unique(a // 32, return_counts=True)
                    assert np.all(per_sector == 4), (g, u, j, w)


def test_line_tables_cached_with_the_frequency_table():
    """The twiddle cache holds the pass twiddles and the frequency table
    beside the twiddles, keyed by canvas and device; a canvas of the
    radix-2 body has neither."""
    dev = torch.device("cpu")
    tw, ptw, freq = shear._line_tables(640, dev)
    assert shear._line_tables(640, dev)[2] is freq
    assert tw.dtype == ptw.dtype == torch.complex64
    assert freq.dtype == torch.int32
    assert np.array_equal(freq.numpy(), shear._freq_table(640))
    assert np.allclose(ptw.numpy(), shear._pass_twiddles(640), atol=1e-7)
    assert np.allclose(tw.numpy(), np.exp(-2j * np.pi * np.arange(640)
                                          / 640), atol=1e-7)
    tw4, ptw4, freq4 = shear._line_tables(4096, dev)
    assert tw4.shape == (4096,) and ptw4 is None and freq4 is None


def _rot90_row(k, r, y, off):
    """``rot90_row`` of csrc/shear_regs.cuh, index for index: row r of the
    band the first x-shear reads from a contiguous y x y frame (row
    stride y, point stride 1) turned by quadrant k → (first element,
    stride between points, number of points, canvas offset)."""
    dy, dx = int(k in (1, 2)), int(k >= 2)
    i, e = r - dy, y - 1
    if i < 0 or i > e:
        return 0, 1, 0, off + dx
    return {0: (i * y, 1, y, off), 1: (e - i, y, y, off),
            2: ((e - i) * y + e, -1, y, off + dx),
            3: (e * y + i, -y, y, off + dx)}[k]


@pytest.mark.parametrize("layout", ["exact", "small"])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_first_shear_reads_the_plain_placement(k, layout):
    """The first x-shear of H2 and H3 reads each frame's rot90 in place:
    its rows, gathered from the frame by the kernel's index arithmetic on
    the canvas, are the rows of ``ops.fft._place_quadrants(...,
    shifted=True)``, which the plain versions place. H2: y + 1 band rows,
    the band at canvas offset px0 of a wider canvas. H3: N rows of an N
    canvas, the turned frame cut back to N x N."""
    y = 6
    rng = np.random.default_rng(k)
    frame = rng.standard_normal((y, y))
    flat = frame.ravel()
    if layout == "exact":
        rows, width, off = y + 1, y + 5, 2
        placed = np.zeros((1, rows, rows))
        fft._place_quadrants(torch.from_numpy(frame[None]),
                             torch.tensor([k]), torch.from_numpy(placed),
                             0, 0, shifted=True)
        ref = np.zeros((rows, width))
        ref[:, off:off + rows] = placed[0]
    else:
        rows = width = y
        off = 0
        ext = np.zeros((1, y + 1, y + 1))
        fft._place_quadrants(torch.from_numpy(frame[None]),
                             torch.tensor([k]), torch.from_numpy(ext),
                             0, 0, shifted=True)
        ref = ext[0, :y, :y]
    got = np.zeros((rows, width))
    for r in range(rows):
        base, step, n, at = _rot90_row(k, r, y, off)
        for pos in range(width):
            j = pos - at
            if 0 <= j < n:
                got[r, pos] = flat[base + j * step]
    assert np.array_equal(got, ref)

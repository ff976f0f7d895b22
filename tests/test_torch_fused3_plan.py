"""The plan of H4's cooperative kernel (csrc/shear3_regs.cuh,
csrc/fft_shear3.cu), on the CPU, as index arithmetic in numpy.

For N ∈ {640, 2048} and both variants (exact: the (y + 1)-row band of y²
frames, N = 4y; small: the full N² canvas):
- every line of every stage (band rows, columns, crop rows) of every frame
  of every group is owned by exactly one (block iteration, line slot) of
  the kernel's grid-strided loops, whatever the grid and the group size;
- the y-shear's column groups read and write whole 32-byte sectors of the
  (G, R1, N) complex64 scratch, in place;
- the first shear's in-place read of each frame's rot90 (``rot90_row``,
  H4's geometry: frames b·y² apart, row r of the band at canvas row
  py0 + r, column 0 at px0) gives the placement the plain versions make
  with ``ops.fft._place_quadrants(..., shifted=True)``, for the exact band
  and for the small variant's (N+1)-extended canvas cut back to N x N.

The kernel against H2/H3 and the plain versions on a card:
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

from test_torch_shear_plan import _rot90_row
from vip_tpu_torch.ops import fft, shear
from vip_tpu_torch.preproc.derotation import _fft_rotate_geometry


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _geometry(variant, N):
    """(B, y, R1, py0, px0, R2, cy0, W3, cx0) of a chunk as the wrappers
    pass it: 50 frames of y = N/4 (exact) or 125 canvases of N (small)."""
    if variant == "exact":
        y = N // 4
        pad, _, py0, px0, cy0, cy1, cx0, cx1 = _fft_rotate_geometry(y, y)
        assert pad == N
        return 50, y, y + 1, py0, px0, cy1 - cy0, cy0, cx1 - cx0, cx0
    return 125, N, N, 0, 0, N, 0, N, 0


def _owners(B, G, lines, group, grid):
    """How many (block, iteration, slot) own each (frame, line) in one
    stage of the kernel: per group of G frames, block `bi` takes
    iterations it = bi, bi + grid, ... < gb·nb (nb = ⌈lines/group⌉), each
    `group` lines of frame g0 + it // nb from line (it % nb)·group; a slot
    past `lines` is inactive."""
    nb = -(-lines // group)
    count = np.zeros((B, lines), dtype=np.int64)
    for g0 in range(0, B, G):
        gb = min(G, B - g0)
        for bi in range(grid):
            its = np.arange(bi, gb * nb, grid)
            line = ((its % nb) * group)[:, None] + np.arange(group)[None]
            frame = np.broadcast_to((g0 + its // nb)[:, None], line.shape)
            active = line < lines
            np.add.at(count, (frame[active], line[active]), 1)
    return count


@pytest.mark.parametrize("budget", [40 << 20, shear._FUSED3_SCRATCH_BYTES])
@pytest.mark.parametrize("grid", [132, 396, 7])
@pytest.mark.parametrize("variant", ["exact", "small"])
@pytest.mark.parametrize("N", [640, 2048])
def test_every_line_owned_once(N, variant, grid, budget, monkeypatch):
    monkeypatch.setattr(shear, "_FUSED3_SCRATCH_BYTES", budget)
    B, y, R1, py0, px0, R2, cy0, W3, cx0 = _geometry(variant, N)
    G = shear._fused3_group(B, R1 * N * 8)
    group = shear._line_group(N, columns=True)
    T = N // 16
    assert group % 4 == 0 and group * T <= 512
    assert shear.register_engine_takes(N)
    for stage, lines in (("band rows", R1), ("columns", N),
                         ("crop rows", R2)):
        count = _owners(B, G, lines, group, grid)
        assert np.all(count == 1), (stage, G)


@pytest.mark.parametrize("variant", ["exact", "small"])
@pytest.mark.parametrize("N", [640, 2048])
def test_column_groups_cover_whole_sectors_in_place(N, variant):
    """Stage 2: the block's C = group adjacent columns of frame f, thread
    c + C·t holding column c from row t; load (u, j) of its first pass
    reads canvas row j·L0 + t + T·u where that row lies in the band
    (canvas rows py0.. py0 + R1, scratch rows from 0), and the last
    inverse pass stores the same points where they lie in the crop
    (canvas rows cy0.. cy0 + R2, scratch rows from 0) of the same column.
    Every warp instruction touches whole 32-byte sectors (4 complex64 by 4
    threads)."""
    B, y, R1, py0, px0, R2, cy0, W3, cx0 = _geometry(variant, N)
    T = N // 16
    C = shear._line_group(N, columns=True)
    p = N
    while p % 2 == 0:
        p //= 2
    R0 = p if p > 1 else 16
    L0, U0 = N // R0, -(-16 // R0)
    assert (N * 8) % 32 == 0        # scratch rows start on sector bounds
    tid = np.arange(C * T)
    c, t = tid % C, tid // C
    f = 1
    for g in (0, 1, N // C - 1):
        col = g * C + c
        for u in range(U0):
            beta = t + T * u
            for j in range(R0):
                pos = j * L0 + beta
                for off, n in ((py0, R1), (cy0, R2)):   # loads, stores
                    k = pos - off
                    active = (beta < L0) & (k >= 0) & (k < n) & (col < N)
                    addr = ((f * R1 + k) * N + col) * 8
                    for w in range(0, C * T, 32):
                        a = addr[w:w + 32][active[w:w + 32]]
                        if a.size == 0:
                            continue
                        assert np.unique(a).size == a.size
                        _, per = np.unique(a // 32, return_counts=True)
                        assert np.all(per == 4), (g, u, j, w)


@pytest.mark.parametrize("variant", ["exact", "small"])
def test_first_shear_reads_the_placement_in_place(variant):
    """Four frames, one per quadrant k, read as stage 1 reads them; the
    band rows against the plain placement of the same frames."""
    N = 128
    B = 4
    if variant == "exact":
        y = N // 4
        _, _, py0, px0, _, _, _, _ = _fft_rotate_geometry(y, y)
        R1 = y + 1
    else:
        y, R1, py0, px0 = N, N, 0, 0
    rng = np.random.default_rng(9)
    frames = rng.standard_normal((B, y, y))
    quad = np.array([0, 1, 2, 3])
    flat = frames.ravel()
    got = np.zeros((B, R1, N))
    for b in range(B):
        for r in range(R1):
            base, step, n, at = _rot90_row(int(quad[b]), r, y, px0)
            for pos in range(N):
                j = pos - at
                if 0 <= j < n:
                    got[b, r, pos] = flat[b * y * y + base + j * step]
    if variant == "exact":
        slab = torch.zeros((B, R1, R1), dtype=torch.float64)
        fft._place_quadrants(torch.from_numpy(frames), torch.from_numpy(quad),
                             slab, 0, 0, shifted=True)
        ref = np.zeros((B, R1, N))
        ref[:, :, px0:px0 + R1] = slab.numpy()
        # band row r is canvas row py0 + r
        assert py0 + R1 <= N
    else:
        ext = torch.zeros((B, N + 1, N + 1), dtype=torch.float64)
        fft._place_quadrants(torch.from_numpy(frames), torch.from_numpy(quad),
                             ext, 0, 0, shifted=True)
        ref = ext.numpy()[:, :N, :N]
    assert np.array_equal(got, ref)


def test_wrappers_place_nothing():
    """The H4 wrappers read the frames in place: the module no longer
    uses the PyTorch placement (zeroed slab, masked rot90 copies and their
    host syncs) that fed the kernel before."""
    import inspect

    assert not hasattr(shear, "_place_quadrants")
    for fn in (shear.rotate_fft_exact_fused3, shear.rotate_fft_small_fused3,
               shear._fused3):
        src = inspect.getsource(fn)
        for banned in ("torch.zeros", "_place_quadrants", "torch.rot90",
                       ".any()", ".item()"):
            assert banned not in src, (fn.__name__, banned)

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips on a host without a
CUDA card. The file imports neither jax nor vip_tpu, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips the repository's conftest files, which set up
jax for the vip_tpu tests.)
"""

import math
import os

import numpy as np
import pytest
import torch

import vip_tpu_torch

from vip_tpu_torch.ops import median, pipeline, shear
from vip_tpu_torch.ops.fft import (rotate_fft_exact_pruned,
                                   rotate_fft_small_plain)
from vip_tpu_torch.ops.median import nanmedian_axis0, nanmedian_plain
from vip_tpu_torch.ops.shear import (fused_shear_supported,
                                     fused_small_supported,
                                     rotate_fft_exact_fused,
                                     rotate_fft_exact_fused3,
                                     rotate_fft_small_fused,
                                     rotate_fft_small_fused3, rotate_exact)
from vip_tpu_torch.preproc.derotation import _fft_rotate_geometry

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


# H2 and H3 against their plain versions: the bound of
# tests/test_pallas_shear.py:39,94
ROT_TOL = 3e-5
# angles in all four quadrants, with the quadrant boundaries
_ANGLES = [0.0, 13.7, 45.0, 61.2, 90.0, 158.9, 225.0, 305.4, -37.5]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _specials(n, shape, seed):
    """Random f32 cube with ±inf, ±0.0, denormals, half-NaN and all-NaN
    pixels (frames past the last are the last)."""
    rng = np.random.default_rng(seed)
    arr = (rng.standard_normal((n,) + shape) * 100).astype(np.float32)
    last = n - 1
    arr[min(3, last), 0, 0] = np.inf
    arr[min(5, last), 0, 1] = -np.inf
    arr[:, 0, 2] = -0.0
    arr[: n // 2, 0, 3] = 0.0
    arr[::2, 0, 4] = np.nan
    arr[:, 0, 5] = np.nan
    arr[min(7, last), 1, :] = 1e-42
    arr[min(8, last), 2, :] = -1e-42
    arr[min(4, last), 3, 7] = np.nan
    return arr


@pytest.mark.parametrize("propagate", [False, True])
@pytest.mark.parametrize("n", [1, 2, 16, 17, 301, 1000, 1650, 1651, 3600])
def test_median_kernel_bit_equal_to_plain(cuda_device, n, propagate):
    """Both bodies (digits up to 1650 frames, bisection above) on 1650
    pixels, no multiple of either tile (32 and 16 pixels), with heavy
    duplicates in row 4."""
    arr = _specials(n, (11, 150), seed=n)
    arr[:, 4, :] = np.round(arr[:, 4, :] / 50)
    arr = torch.from_numpy(arr).to(cuda_device)
    before = median.launches
    got = nanmedian_axis0(arr, propagate=propagate)
    ref = nanmedian_plain(arr, 0, propagate)
    torch.cuda.synchronize()
    assert median.launches == before + 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_median_kernel_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError):
        nanmedian_axis0(torch.zeros((4, 3, 3), dtype=torch.float64,
                                    device=cuda_device))
    with pytest.raises(ValueError):
        nanmedian_axis0(torch.zeros((3, 4, 3), device=cuda_device)
                        .transpose(0, 1))


@pytest.mark.parametrize("n", [1, 9])
@pytest.mark.parametrize("y", [32, 64, 96, 128, 160, 256, 512, 640])
def test_shear_kernel_matches_plain(cuda_device, y, n):
    """H2 on 1 and 9 frames (a batch of one, an odd batch). Canvases up to
    2048 (y ≤ 512) run the register engine, y = 640 (N = 2560) the
    radix-2 body."""
    pad_y, _, py0, px0, cy0, cy1, cx0, cx1 = _fft_rotate_geometry(y, y)
    geom = (pad_y, py0, px0, cy0, cy1, cx0, cx1)
    assert fused_shear_supported(y, pad_y, torch.float32, cuda_device)
    assert shear.register_engine_takes(pad_y) == (y <= 512)
    rng = np.random.default_rng(y)
    frames = torch.as_tensor(rng.standard_normal((n, y, y)),
                             dtype=torch.float32, device=cuda_device)
    angles = torch.tensor(_ANGLES[-n:], device=cuda_device)
    before = shear.launches
    got = rotate_fft_exact_fused(frames, angles, *geom)
    ref32 = rotate_fft_exact_pruned(frames, angles, *geom)
    ref64 = rotate_fft_exact_pruned(frames.double(), angles.double(), *geom)
    torch.cuda.synchronize()
    assert shear.launches == before + 3
    for ref in (ref32, ref64):
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got.double() - ref.double()).abs().max()) \
            <= ROT_TOL * scale


def test_shear_route_and_gate(cuda_device):
    frames = torch.zeros((2, 33, 33), device=cuda_device)   # odd: plain
    before = shear.launches
    rotate_exact(frames, torch.tensor([10.0, 20.0]))
    assert shear.launches == before
    pad_y = _fft_rotate_geometry(33, 33)[0]
    geom = (pad_y,) + _fft_rotate_geometry(33, 33)[2:]
    with pytest.raises(ValueError):
        rotate_fft_exact_fused(frames, torch.tensor([10.0, 20.0]), *geom)
    even = torch.zeros((2, 64, 64), dtype=torch.float64, device=cuda_device)
    g64 = _fft_rotate_geometry(64, 64)
    with pytest.raises(ValueError):
        rotate_fft_exact_fused(even, torch.tensor([10.0, 20.0]), g64[0],
                               *g64[2:])


def test_median_gate_frame_bound(cuda_device):
    assert median.nanmedian_supported(torch.empty((3600, 1, 2),
                                                  device=cuda_device))
    assert not median.nanmedian_supported(torch.empty((3601, 1, 2),
                                                      device=cuda_device))
    for n, body in ((1, "digits"), (1650, "digits"), (1651, "bisection"),
                    (3600, "bisection")):
        cfg = median.median_config(n)
        assert cfg["body"] == body == median.median_body(n)
        assert cfg["blocks_per_sm"] >= 1 and cfg["spill_bytes"] == 0
        assert cfg["threads"] == (1024 if body == "digits" else 256)


@pytest.mark.parametrize("P", list(range(1, 17)))
def test_small_shear_kernel_matches_plain(cuda_device, P):
    N = 128 * P
    assert fused_small_supported(N, torch.float32, cuda_device)
    rng = np.random.default_rng(100 + P)
    frames = torch.as_tensor(rng.standard_normal((9, N, N)),
                             dtype=torch.float32, device=cuda_device)
    angles = torch.tensor(_ANGLES, device=cuda_device)
    before = shear.small_launches
    got = rotate_fft_small_fused(frames, angles)
    ref32 = rotate_fft_small_plain(frames, angles)
    ref64 = rotate_fft_small_plain(frames.double(), angles.double())
    torch.cuda.synchronize()
    assert shear.small_launches == before + 3
    for ref in (ref32, ref64):
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got.double() - ref.double()).abs().max()) \
            <= ROT_TOL * scale


def test_small_shear_kernel_rejects_what_it_does_not_take(cuda_device):
    angles = torch.tensor([10.0, 20.0], device=cuda_device)
    bad = (torch.zeros((2, 130, 130), device=cuda_device),        # 128·P
           torch.zeros((2, 128 * 17, 128 * 17), device=cuda_device),
           torch.zeros((2, 256, 256), dtype=torch.float64,
                       device=cuda_device),
           torch.zeros((2, 256, 128), device=cuda_device),
           torch.zeros((2, 256, 256), device=cuda_device).transpose(1, 2))
    before = shear.small_launches
    for cube in bad:
        with pytest.raises(ValueError):
            rotate_fft_small_fused(cube, angles)
    assert shear.small_launches == before


@pytest.mark.parametrize("mode", ["fused", "packed"])
def test_small_route_on_the_card(cuda_device, monkeypatch, mode):
    """rot_mode='fft-small' runs H3 on a CUDA float32 cube unless
    VIP_SMALL_SHEAR=packed, and float64 takes the packed path."""
    monkeypatch.setenv("VIP_SMALL_SHEAR", mode)
    rng = np.random.default_rng(7)
    cube = torch.as_tensor(rng.standard_normal((6, 96, 96)),
                           dtype=torch.float32, device=cuda_device)
    angles = torch.linspace(0.0, 50.0, 6, device=cuda_device)
    before = shear.small_launches
    got = pipeline._derotate_frames(cube, angles, chunk=4,
                                    rot_mode="fft-small")
    torch.cuda.synchronize()
    assert shear.small_launches == before + (6 if mode == "fused" else 0)
    pipeline._derotate_frames(cube.double(), angles.double(), chunk=4,
                              rot_mode="fft-small")
    assert shear.small_launches == before + (6 if mode == "fused" else 0)
    assert tuple(got.shape) == (6, 96, 96)
    assert bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# H4: the three shears in one cooperative launch
# ---------------------------------------------------------------------------
def _within(got, refs):
    for ref in refs:
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got.double() - ref.double()).abs().max()) \
            <= ROT_TOL * scale


@pytest.mark.parametrize("y", [64, 96, 160, 512, 640])
def test_fused3_exact_matches_plain_and_h2(cuda_device, y):
    """Nine frames. H4 runs H2's line engine on each canvas (the register
    engine up to N = 2048, the radix-2 body at y = 640, N = 2560) with the
    same tables and coefficients, so it is bit-equal to H2, and within
    ROT_TOL of the plain versions."""
    geom = _fft_rotate_geometry(y, y)
    geom = (geom[0],) + geom[2:]
    rng = np.random.default_rng(y)
    frames = torch.as_tensor(rng.standard_normal((9, y, y)),
                             dtype=torch.float32, device=cuda_device)
    angles = torch.tensor(_ANGLES, device=cuda_device)
    before = shear.fused3_launches
    got = rotate_fft_exact_fused3(frames, angles, *geom)
    h2 = rotate_fft_exact_fused(frames, angles, *geom)
    ref32 = rotate_fft_exact_pruned(frames, angles, *geom)
    ref64 = rotate_fft_exact_pruned(frames.double(), angles.double(), *geom)
    torch.cuda.synchronize()
    assert shear.fused3_launches == before + 1
    assert torch.equal(got, h2)
    _within(got, (ref32, ref64))


@pytest.mark.parametrize("budget_mb", [9, 20, 40])
def test_fused3_group_walk_is_bit_equal(cuda_device, monkeypatch,
                                        budget_mb):
    """A scratch budget of one, two and four 512² frames makes the launch
    walk 9, 5 and 3 groups; the frames come out as H2's."""
    monkeypatch.setattr(shear, "_FUSED3_SCRATCH_BYTES", budget_mb << 20)
    geom = _fft_rotate_geometry(512, 512)
    geom = (geom[0],) + geom[2:]
    rng = np.random.default_rng(5)
    frames = torch.as_tensor(rng.standard_normal((9, 512, 512)),
                             dtype=torch.float32, device=cuda_device)
    angles = torch.tensor(_ANGLES, device=cuda_device)
    assert shear._fused3_group(9, 513 * 2048 * 8) == {9: 1, 20: 2,
                                                      40: 4}[budget_mb]
    got = rotate_fft_exact_fused3(frames, angles, *geom)
    h2 = rotate_fft_exact_fused(frames, angles, *geom)
    torch.cuda.synchronize()
    assert torch.equal(got, h2)


def test_fused3_stage_stamps(cuda_device, monkeypatch):
    """With a stamps buffer H4 records block 0's %globaltimer at the start
    and after each of its 3 x groups grid barriers, in order, and its
    frames do not change."""
    monkeypatch.setattr(shear, "_FUSED3_SCRATCH_BYTES", 20 << 20)
    geom = _fft_rotate_geometry(512, 512)
    N, py0, px0, cy0, cy1, cx0, cx1 = (geom[0],) + geom[2:]
    rng = np.random.default_rng(6)
    frames = torch.as_tensor(rng.standard_normal((5, 512, 512)),
                             dtype=torch.float32, device=cuda_device)
    angles = torch.tensor(_ANGLES[:5], device=cuda_device)
    lib, a, b, tables, k = shear._exact_setup(frames, angles, N, "stamps")
    out = torch.empty((5, cy1 - cy0, cx1 - cx0), device=cuda_device)
    stamps = torch.zeros(1 + 3 * 3, dtype=torch.int64, device=cuda_device)
    shear._fused3(lib, frames, k, out, a, b, tables, N, 513, py0, px0,
                  cy1 - cy0, cy0, cx1 - cx0, cx0, "stamps", stamps=stamps)
    ref = rotate_fft_exact_fused3(frames, angles, N, py0, px0, cy0, cy1,
                                  cx0, cx1)
    torch.cuda.synchronize()
    ns = stamps.cpu().numpy()
    assert np.all(ns > 0) and np.all(np.diff(ns) >= 0)
    assert torch.equal(out, ref)


def test_fused3_config_is_one_wave_of_resident_blocks(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for N, threads in ((2048, 512), (640, 160), (2560, 256)):
        cfg = shear.fused3_config(N)
        assert cfg["threads"] == threads
        assert cfg["grid"] == cfg["blocks_per_sm"] * sms >= sms


@pytest.mark.parametrize("P", list(range(1, 17)))
def test_fused3_small_matches_plain_and_h3(cuda_device, P):
    N = 128 * P
    rng = np.random.default_rng(200 + P)
    frames = torch.as_tensor(rng.standard_normal((9, N, N)),
                             dtype=torch.float32, device=cuda_device)
    angles = torch.tensor(_ANGLES, device=cuda_device)
    before = shear.fused3_launches
    got = rotate_fft_small_fused3(frames, angles)
    h3 = rotate_fft_small_fused(frames, angles)
    ref32 = rotate_fft_small_plain(frames, angles)
    ref64 = rotate_fft_small_plain(frames.double(), angles.double())
    torch.cuda.synchronize()
    assert shear.fused3_launches == before + 1
    assert torch.equal(got, h3)
    _within(got, (ref32, ref64))


def test_fused3_rejects_what_it_does_not_take(cuda_device):
    a2 = torch.tensor([10.0, 20.0], device=cuda_device)
    g33 = _fft_rotate_geometry(33, 33)
    g64 = _fft_rotate_geometry(64, 64)
    before = shear.fused3_launches
    with pytest.raises(ValueError):     # odd frames
        rotate_fft_exact_fused3(torch.zeros((2, 33, 33), device=cuda_device),
                                a2, g33[0], *g33[2:])
    with pytest.raises(ValueError):     # float64
        rotate_fft_exact_fused3(torch.zeros((2, 64, 64), dtype=torch.float64,
                                            device=cuda_device), a2, g64[0],
                                *g64[2:])
    with pytest.raises(ValueError):     # not contiguous
        rotate_fft_exact_fused3(torch.zeros((64, 2, 64), device=cuda_device)
                                .transpose(0, 1), a2, g64[0], *g64[2:])
    for cube in (torch.zeros((2, 130, 130), device=cuda_device),
                 torch.zeros((2, 128 * 17, 128 * 17), device=cuda_device),
                 torch.zeros((2, 256, 256), dtype=torch.float64,
                             device=cuda_device),
                 torch.zeros((2, 256, 128), device=cuda_device)):
        with pytest.raises(ValueError):
            rotate_fft_small_fused3(cube, a2)
    assert shear.fused3_launches == before


@pytest.mark.parametrize("mode,kernel", [("auto", "H2"), ("fused", "H2"),
                                         ("fused3", "H4"), ("pruned", None)])
def test_exact_shear_routes_on_the_card(cuda_device, monkeypatch, mode,
                                        kernel):
    monkeypatch.setenv("VIP_EXACT_SHEAR", mode)
    rng = np.random.default_rng(11)
    frames = torch.as_tensor(rng.standard_normal((5, 96, 96)),
                             dtype=torch.float32, device=cuda_device)
    angles = torch.linspace(0.0, 50.0, 5, device=cuda_device)
    before = {"H2": shear.launches, "H4": shear.fused3_launches}
    got = pipeline._derotate_frames(frames, angles, chunk=3, rot_mode="fft")
    torch.cuda.synchronize()
    after = {"H2": shear.launches, "H4": shear.fused3_launches}
    want = {"H2": 0, "H4": 0}
    if kernel == "H2":
        want["H2"] = 6              # two chunks, three launches each
    elif kernel == "H4":
        want["H4"] = 2              # two chunks, one launch each
    assert {k: after[k] - before[k] for k in after} == want
    ref = rotate_exact(frames.double(), -angles.double())
    _within(got, (ref,))


def test_small_shear_fused3_route_on_the_card(cuda_device, monkeypatch):
    monkeypatch.setenv("VIP_SMALL_SHEAR", "fused3")
    rng = np.random.default_rng(7)
    cube = torch.as_tensor(rng.standard_normal((6, 96, 96)),
                           dtype=torch.float32, device=cuda_device)
    angles = torch.linspace(0.0, 50.0, 6, device=cuda_device)
    before = (shear.small_launches, shear.fused3_launches)
    got = pipeline._derotate_frames(cube, angles, chunk=4,
                                    rot_mode="fft-small")
    torch.cuda.synchronize()
    assert (shear.small_launches, shear.fused3_launches) == \
        (before[0], before[1] + 2)
    monkeypatch.setenv("VIP_SMALL_SHEAR", "fused")
    _within(got, (pipeline._derotate_frames(cube, angles, chunk=4,
                                            rot_mode="fft-small"),))


def test_companion_search_on_the_card(cuda_device, monkeypatch):
    """median_sub → snrmap → detection on a CUDA float32 cube against the
    CPU float64 parity mode; H1 and H4 (VIP_EXACT_SHEAR=fused3) run."""
    from vip_tpu_torch.metrics import detection, snrmap
    from vip_tpu_torch.psfsub import median_sub

    monkeypatch.setenv("VIP_EXACT_SHEAR", "fused3")
    rng = np.random.default_rng(3)
    n, size, sep = 40, 64, 14.0
    angles = np.linspace(0.0, 60.0, n)
    yy, xx = np.mgrid[:size, :size]
    cube = 0.5 * rng.standard_normal((n, size, size))
    c = size // 2
    for i, a in enumerate(np.deg2rad(angles)):
        cube[i] += 2.0 * np.exp(-((yy - c + sep * np.sin(a)) ** 2
                                  + (xx - c - sep * np.cos(a)) ** 2) / 5.77)
    before = (median.launches, shear.fused3_launches, shear.launches)
    got = median_sub(torch.as_tensor(cube, dtype=torch.float32,
                                     device=cuda_device), angles,
                     verbose=False)
    torch.cuda.synchronize()
    assert median.launches >= before[0] + 2      # model and collapse
    assert shear.fused3_launches > before[1] and shear.launches == before[2]
    ref = median_sub(torch.as_tensor(cube), angles, verbose=False)
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got.cpu().double() - ref).abs().max()) <= 1e-4 * scale
    smap = snrmap(got, 4, verbose=False)
    assert smap.is_cuda and smap.dtype == torch.float32
    smap_ref = snrmap(ref, 4, verbose=False)
    assert float((smap.cpu().double() - smap_ref).abs().max()) <= 1e-3 * max(
        float(smap_ref.abs().max()), 1.0)
    ys, xs = detection(got, 4, mode="lpeaks", bkg_sigma=3, snr_thresh=3,
                       plot=False, verbose=False)
    assert any(abs(y - c) <= 3 and abs(x - c - sep) <= 3
               for y, x in zip(np.atleast_1d(ys), np.atleast_1d(xs)))


def test_inject_ladder_is_bit_reproducible(cuda_device):
    """The ladder adds rung by rung into slices of the cube (no atomic
    scatter-add): two runs give the same bits; and it agrees with the
    CPU float64 ladder."""
    from vip_tpu_torch.ops.inject import inject_ladder_adi

    rng = np.random.default_rng(21)
    cube = rng.standard_normal((60, 96, 96))
    angles = np.linspace(0.0, 70.0, 60)
    yy, xx = np.mgrid[:9, :9] - 4.0
    stamp = np.exp(-(yy ** 2 + xx ** 2) / 5.77)
    rads, fluxes = [10.0, 25.5, 44.0], [3.0, 2.0, 5.0]   # the last overhangs
    dev = torch.as_tensor(cube, dtype=torch.float32, device=cuda_device)
    a = inject_ladder_adi(dev, stamp, angles, rads, fluxes, 0.7)
    b = inject_ladder_adi(dev, stamp, angles, rads, fluxes, 0.7)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    ref = inject_ladder_adi(torch.as_tensor(cube), stamp, angles, rads,
                            fluxes, 0.7)
    assert float((a.cpu().double() - ref).abs().max()) <= 1e-5 * max(
        float(ref.abs().max()), 1.0)


def _plain_route(monkeypatch):
    """Route the derotation and the median through their plain versions on
    the card (the exact rotation's 'pruned' route, the plain median)."""
    from vip_tpu_torch.preproc import subsampling

    monkeypatch.setenv("VIP_EXACT_SHEAR", "pruned")
    monkeypatch.setattr(subsampling, "nanmedian_supported",
                        lambda arr, ax=0: False)


def test_pca_incremental_kernels_match_plain(cuda_device, monkeypatch,
                                             tmp_path):
    from vip_tpu_torch.fits import write_fits
    from vip_tpu_torch.psfsub import pca_incremental

    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:64, :64] - 32.0
    halo = 20 * np.exp(-(yy ** 2 + xx ** 2) / 200.0)
    cube = halo + rng.standard_normal((90, 64, 64))
    angles = np.linspace(0.0, 60.0, 90)
    path = str(tmp_path / "cube.fits")
    write_fits(path, cube.astype(np.float32), verbose=False)
    vip_tpu_torch.set_device("cuda")
    try:
        before = (median.launches, shear.launches)
        got = pca_incremental(path, angles, batch=25, ncomp=4, verbose=False)
        torch.cuda.synchronize()
        assert median.launches - before[0] == 4            # one a batch
        assert shear.launches - before[1] == 3 * 4         # 25 ≤ 50 frames
        _plain_route(monkeypatch)
        before = (median.launches, shear.launches)
        ref = pca_incremental(path, angles, batch=25, ncomp=4, verbose=False)
        assert (median.launches, shear.launches) == before
    finally:
        vip_tpu_torch.set_device("cpu")
    assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)


def _golden_companions(golden, name, meta):
    """The companions (beta Pic b, the injected one) that VIP's detection
    found within 3 px on the golden frame ``name``."""
    found = np.load(os.path.join(golden, f"{name}_detect.npy"))
    return [c for c in (tuple(meta["planet_yx"]), tuple(meta["injected_yx"]))
            if any(abs(y - c[0]) <= 3 and abs(x - c[1]) <= 3
                   for y, x in found)]


_F2 = (("pca_adi", "pca", dict(svd_mode="lapack")),
       ("medsub_adi", "median_sub", dict(mode="fullfr", imlib="vip-fft",
                                         interpolation=None)),
       ("pca_ann_adi", "pca_annular", dict(n_segments="auto")),
       ("pca_incr_adi", "pca", dict(batch=30)))


# F2's gate: the card's float32 frame within F2_RATIO times the CPU's
# float32 error against the golden, at least F2_FLOOR
F2_RATIO, F2_FLOOR = 10.0, 1e-4


def _f2_frame(fn, kwargs, cube, angles, fwhm):
    import vip_tpu_torch.psfsub as tps

    frame = getattr(tps, fn)(cube=cube, angle_list=angles, fwhm=fwhm,
                             verbose=False, **kwargs)
    return frame.cpu().double().numpy() if isinstance(frame, torch.Tensor) \
        else np.asarray(frame, np.float64)


@pytest.mark.parametrize("name,fn,kwargs", _F2, ids=[c[0] for c in _F2])
def test_goldens_in_float32_on_the_card(cuda_device, name, fn, kwargs):
    """F2: the goldens' configurations on the NACO replica in float32. The
    card's frame must be as close to VIP's float64 golden as the same
    call in float32 on the CPU, within F2_RATIO (ROADMAP Queue 3, F2:
    cuSOLVER's Jacobi SVD made the PCA frames 110x and 23x worse), and
    the 3-px detection oracle must find each of the two companions (beta
    Pic b, the injected one) that VIP's detection found on the golden."""
    from vip_tpu_torch.metrics import detection

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
    meta = np.load(os.path.join(golden, "meta.npz"))
    cube = np.load(os.path.join(golden, "inputs.npz"))["cube"].astype(
        np.float32)
    fwhm = float(meta["fwhm"])
    ref = np.load(os.path.join(golden, f"{name}.npy"))
    frame = _f2_frame(fn, kwargs, torch.as_tensor(cube, device=cuda_device),
                      meta["angles"], fwhm)
    err = np.abs(frame - ref).max()
    err_cpu = np.abs(_f2_frame(fn, kwargs, torch.as_tensor(cube),
                               meta["angles"], fwhm) - ref).max()
    print(f"F2 {name}: float32 vs golden max abs err, card {err:.3e}, CPU "
          f"{err_cpu:.3e}")
    assert np.isfinite(frame).all()
    assert err <= max(F2_RATIO * err_cpu, F2_FLOOR)
    ys, xs = detection(frame, fwhm=fwhm, mode="lpeaks", bkg_sigma=5,
                       matched_filter=False, mask=True, snr_thresh=2,
                       plot=False, verbose=False)
    for ey, ex in _golden_companions(golden, name, meta):
        assert any(abs(y - ey) <= 3 and abs(x - ex) <= 3
                   for y, x in zip(np.atleast_1d(ys), np.atleast_1d(xs))), \
            f"{name}: source at {(ey, ex)} not recovered"


# ---------------------------------------------------------------------------
# slice 4: each entry point on the card, through H2 (and H1 where it
# collapses by the median), against the CPU float64 mode
# ---------------------------------------------------------------------------
# relative to max(|ref|, 1): the direct subtractions differ by float32
# rounding (LOCI's float32 eigh with its cutoff: 1.8e-4 from float64 on the
# CPU); the iterative ones (multiplicative updates, GoDec, the greedy
# loops) also by where their stopping rules and thresholds fall (annular
# NMF: 2.6e-3 from float64 on the CPU)
DIRECT_TOL, ITERATIVE_TOL = 1e-3, 1e-2


def _slice4_inputs():
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[:64, :64] - 32.0
    halo = 10 * np.exp(-(yy ** 2 + xx ** 2) / 300.0)
    cube = halo + rng.standard_normal((40, 64, 64))
    return cube, np.linspace(0.0, 60.0, 40)


def _slice4_cases():
    import vip_tpu_torch.greedy as tgr
    import vip_tpu_torch.psfsub as tps

    rolls = np.array([0.0] * 20 + [25.0] * 20)
    # (name, function, keywords, angles, positive cube, (H1, H2), tolerance)
    return [
        ("nmf", tps.nmf, dict(ncomp=3, max_iter=200,
                              handle_neg="subtr_min"), None, False, (1, 3),
         ITERATIVE_TOL),
        ("nmf_annular", tps.nmf_annular,
         dict(ncomp=3, radius_int=8, asize=4, max_iter=200,
              handle_neg="subtr_min"), None, False, (1, 3), ITERATIVE_TOL),
        ("llsg", tps.llsg, dict(fwhm=4, rank=5, thresh=1, max_iter=5,
                                random_seed=10), None, False, (2, 3),
         ITERATIVE_TOL),
        ("xloci", tps.xloci, dict(fwhm=4, asize=4, radius_int=8,
                                  n_segments="auto", dist_threshold=100,
                                  delta_rot=0.5, solver="lstsq"),
         None, False, (1, 3), DIRECT_TOL),
        # 7 annuli, each derotated and collapsed
        ("frame_diff", tps.frame_diff,
         dict(fwhm=4, metric="l1", dist_threshold=90, delta_rot=0.5,
              radius_int=4, asize=4), None, False, (7, 21), DIRECT_TOL),
        ("roll_sub", tps.roll_sub, dict(), rolls, False, (0, 6), DIRECT_TOL),
        ("roll_sub individual", tps.roll_sub,
         dict(mode="individual", collapse="median"), rolls, False, (1, 3),
         DIRECT_TOL),
        # pca, STIM (3); then the rotated signal, pca twice, STIM
        ("ipca", tgr.ipca, dict(ncomp=3, nit=2), None, False, (3, 18),
         ITERATIVE_TOL),
        # nmf and its smoothed derotation, STIM; then the signal, nmf and
        # its derotation, nmf without the signal, STIM
        ("inmf", tgr.inmf, dict(ncomp=3, nit=2, max_iter=100), None, True,
         (5, 24), ITERATIVE_TOL),
        # roll_sub, STIM and the rotated signal, twice (the mean collapse
        # launches no H1)
        ("iroll", tgr.iroll, dict(mode="individual"), rolls, False, (0, 18),
         ITERATIVE_TOL),
    ]


@pytest.mark.parametrize("case", range(10))
def test_slice4_entry_points_on_the_card(cuda_device, case):
    name, fn, kwargs, angles, positive, (n_h1, n_h2), tol = \
        _slice4_cases()[case]
    cube, default_angles = _slice4_inputs()
    if positive:
        cube = cube - cube.min() + 1.0
    angles = default_angles if angles is None else angles
    vip_tpu_torch.set_device("cuda")
    try:
        before = (median.launches, shear.launches)
        got = fn(cube=cube, angle_list=angles, verbose=False, **kwargs)
        torch.cuda.synchronize()
        counts = (median.launches - before[0], shear.launches - before[1])
    finally:
        vip_tpu_torch.set_device("cpu")
    ref = fn(cube=cube, angle_list=angles, verbose=False, **kwargs).numpy()
    err = np.abs(got.cpu().double().numpy() - ref).max() \
        / max(np.abs(ref).max(), 1.0)
    print(f"{name} on the card: H1 {counts[0]}, H2 {counts[1]}; against "
          f"the CPU float64 mode {err:.3e}")
    assert got.is_cuda and got.dtype == torch.float32
    assert counts == (n_h1, n_h2), name
    assert err <= tol, name


# NEGFC (slice 5): a companion injected at (16 px, 30°) into 40x64² frames
# of smooth noise; its float32 log-probabilities on the card against the
# CPU float64 mode (relative: the float32 SVD and projections of a noise
# annulus, then a sum of squares; measured 2.4e-6 on an H100 80GB HBM3 at
# 700 W), and the kernels against the plain route on the card (relative,
# as chip_smoke.py's PIPE_TOL)
NEGFC_TRUTH = (16.0, 30.0, 40.0)
NEGFC_TOL, NEGFC_PLAIN_TOL = 1e-4, 1e-5


def _negfc_inputs():
    import vip_tpu_torch.fm as tfm
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(9)
    angles = np.linspace(0.0, 60.0, 40)
    yy, xx = np.mgrid[:13, :13]
    psf = np.exp(-((yy - 6) ** 2 + (xx - 6) ** 2) / (2 * (4 / 2.355) ** 2))
    psfn = tfm.normalize_psf(psf, fwhm=4, verbose=False)
    cube = gaussian_filter(rng.standard_normal((40, 64, 64)), 1.0) * 0.3
    r, theta, f = NEGFC_TRUTH
    cube = tfm.cube_inject_companions(cube, psfn, angles, flevel=f,
                                      rad_dists=[r], theta=theta)
    return cube, angles, psfn


def _near_truth(r, theta, f, tol=(0.5, 2.0, 0.2)):
    r0, th0, f0 = NEGFC_TRUTH
    return (abs(r - r0) < tol[0]
            and abs((theta - th0 + 180) % 360 - 180) < tol[1]
            and abs(f - f0) < tol[2] * f0)


def test_negfc_batched_lnprob_on_the_card(cuda_device, monkeypatch):
    from vip_tpu_torch.ops.negfc_model import make_batched_lnprob

    cube, angles, psfn = _negfc_inputs()
    r, theta, f = NEGFC_TRUTH
    bounds = [(r - 2, r + 2), (theta - 10, theta + 10), (0, 5 * f)]
    params = np.array([[r, theta, f], [r + 0.4, theta - 1.5, f * 1.2],
                       [r - 0.6, theta + 2.0, f * 0.7], [r, theta, 0.0],
                       [r + 0.2, theta, f * 1.05], [r + 3.0, theta, f]])
    args = (angles, psfn, 1, 8, r, theta, 1.0, 4.0, 0.0, 0.05 ** 2, bounds)
    ref = make_batched_lnprob(cube, *args)(params).numpy()
    cube_t = torch.as_tensor(cube, dtype=torch.float32, device=cuda_device)
    lnprob = make_batched_lnprob(cube_t, *args)
    before = (median.launches, shear.launches)
    got = lnprob(params)
    torch.cuda.synchronize()
    counts = (median.launches - before[0], shear.launches - before[1])
    fin = np.isfinite(ref)
    assert got.is_cuda and got.dtype == torch.float32
    got = got.cpu().double().numpy()
    err = np.max(np.abs(got[fin] - ref[fin]) / np.abs(ref[fin]))
    print(f"NEGFC lnprob on the card: H1 {counts[0]}, H2 {counts[1]}; "
          f"against the CPU float64 mode {err:.3e}")
    # one median for the batch, one chunk of 200 frames (3 H2 launches)
    assert counts == (1, 3)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() == 5 and err <= NEGFC_TOL
    _plain_route(monkeypatch)
    plain = lnprob(params).cpu().double().numpy()
    assert (median.launches, shear.launches) == (before[0] + 1,
                                                 before[1] + 3)
    assert np.max(np.abs(got[fin] - plain[fin]) / np.abs(plain[fin])) \
        <= NEGFC_PLAIN_TOL


def _negfc_on_the_card(run):
    """``run(cube on the card)`` with numpy input going to the card too;
    its result and the H1, H2 launches it made."""
    cube, angles, psfn = _negfc_inputs()
    cube_t = torch.as_tensor(cube, dtype=torch.float32, device="cuda")
    vip_tpu_torch.set_device("cuda")
    try:
        before = (median.launches, shear.launches)
        out = run(cube_t, angles, psfn)
        torch.cuda.synchronize()
        counts = (median.launches - before[0], shear.launches - before[1])
    finally:
        vip_tpu_torch.set_device("cpu")
    return out, counts


def test_negfc_firstguess_on_the_card(cuda_device):
    import vip_tpu_torch.fm as tfm

    r, theta, _ = NEGFC_TRUTH
    xy = (32 + r * np.cos(np.deg2rad(theta)),
          32 + r * np.sin(np.deg2rad(theta)))
    (r0, th0, f0), counts = _negfc_on_the_card(
        lambda cube, angles, psfn: tfm.firstguess(
            cube, angles, psfn, [xy], f_range=np.geomspace(4, 400, 12),
            verbose=False))
    print(f"NEGFC firstguess on the card: ({r0[0]:.3f}, {th0[0]:.3f}, "
          f"{f0[0]:.3f}); H1 {counts[0]}, H2 {counts[1]}")
    assert _near_truth(r0[0], th0[0], f0[0])
    # one pca_annulus (a derotation: 3 H2 launches, a median: 1 H1) for
    # the annulus statistics and each χ²
    assert counts[0] > 13 and counts[1] == 3 * counts[0]


def test_negfc_mcmc_on_the_card(cuda_device):
    """``mcmc_negfc_sampling`` on the card, the small shape of
    chip_smoke.py's phase 16 sampler (cut to every 10th frame there): the
    stretch moves' draws come from a CPU generator seeded with
    ``rng_seed``, so the float32 chain through H1 and H2 takes the same
    steps as the CPU float64 mode's, and the float64 chain on the card
    (the plain routes) equals it."""
    import vip_tpu_torch.fm as tfm

    r, theta, f = NEGFC_TRUTH
    start = (r + 0.3, theta + 1.0, f * 1.1)
    kw = dict(ncomp=1, annulus_width=8, aperture_radius=1, fwhm=4,
              nwalkers=8, niteration_min=3, niteration_limit=3,
              conv_test="gb", rng_seed=3, verbosity=0)
    cube, angles, psfn = _negfc_inputs()
    ref = tfm.mcmc_negfc_sampling(cube, angles, psfn, start, **kw)
    chain, counts = _negfc_on_the_card(
        lambda c, a, p: tfm.mcmc_negfc_sampling(c, a, p, start, **kw))
    f64 = tfm.mcmc_negfc_sampling(torch.as_tensor(cube, device=cuda_device),
                                  angles, psfn, start, **kw)
    print(f"NEGFC MCMC on the card: chain {chain.shape}; H1 {counts[0]}, "
          f"H2 {counts[1]}")
    assert chain.shape == ref.shape and ref.shape[1] == 3
    assert np.all(np.isfinite(chain))
    assert counts[0] > 0 and counts[1] > 0
    assert np.any(chain[:, -1] != chain[:, 0])      # proposals accepted
    assert np.max(np.abs(chain - ref) / np.abs(ref)) <= 1e-6
    assert np.max(np.abs(np.asarray(f64) - ref) / np.abs(ref)) <= 1e-8


def test_negfc_nested_sampling_on_the_card(cuda_device):
    import vip_tpu_torch.fm as tfm

    r, theta, f = NEGFC_TRUTH
    res, counts = _negfc_on_the_card(
        lambda cube, angles, psfn: tfm.nested_negfc_sampling(
            (r + 0.3, theta + 1.0, f * 1.1), cube, angles, psfn, 4, ncomp=1,
            npoints=20, dlogz=1.0, w=(2, 4, 0.5 * f),
            rstate=np.random.RandomState(0), verbose=False))
    mean = tfm.nested_sampling_results(res, verbose=False)[:, 0]
    print(f"NEGFC nested sampling on the card: {mean}, {res.niter} "
          f"iterations; H1 {counts[0]}, H2 {counts[1]}")
    assert _near_truth(*mean)
    # two reductions for the annulus statistics, one a likelihood
    assert counts[0] >= 2 + 20 + res.niter and counts[1] == 3 * counts[0]


def test_negfc_speckle_noise_on_the_card(cuda_device):
    import vip_tpu_torch.fm as tfm
    import vip_tpu_torch.psfsub as tps

    out, counts = _negfc_on_the_card(
        lambda cube, angles, psfn: tfm.speckle_noise_uncertainty(
            cube, NEGFC_TRUTH, np.array([0.0, 120.0, 240.0, 360.0]), angles,
            tps.pca_annulus, psfn, 4, 1, algo_options=dict(ncomp=1),
            mu_sigma=None, verbose=False, full_output=True))
    offsets = out[3]
    print(f"NEGFC speckle noise on the card: offsets {offsets.tolist()}; "
          f"H1 {counts[0]}, H2 {counts[1]}")
    assert offsets.shape == (3, 3)
    r, theta, f = NEGFC_TRUTH
    for dr, dth, df in offsets:
        assert _near_truth(r + dr, theta + dth, f + df)
    assert counts[0] > 3 and counts[1] == 3 * counts[0]


# Slice 6, the inverse problems: ANDROMEDA, FMMF and FastPACO on small
# cubes, float32 on the card against the CPU float64 mode, relative to
# max|ref|: float32 sums over windows, patches and KLIP bases (measured
# at most 2.1e-6, 1.1e-6 and 2.2e-6 on an H100 80GB HBM3 at 700 W)
ANDROMEDA_CARD_TOL = FMMF_CARD_TOL = PACO_CARD_TOL = 1e-5


def _companion_cube(n, size, angles, sep, theta, peak, seed, level=0.0):
    """White noise (plus ``level``) with a Gaussian companion of FWHM 4 at
    (sep, theta) of the frame centre turning with ``angles``."""
    rng = np.random.default_rng(seed)
    cube = rng.standard_normal((n, size, size)) + level
    yy, xx = np.mgrid[:size, :size]
    c = size // 2
    for k, a in enumerate(angles):
        t = np.deg2rad(theta - a)
        cube[k] += peak * np.exp(
            -((yy - c - sep * np.sin(t)) ** 2 + (xx - c - sep * np.cos(t))
              ** 2) / (2 * (4 / 2.355) ** 2))
    return cube


def _gaussian_stamp(size, fwhm=4.0):
    yy, xx = np.mgrid[:size, :size]
    c = size // 2
    return np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (2 * (fwhm / 2.355)
                                                        ** 2))


def _card_and_cpu(run, cube):
    """``run(cube tensor)`` with the cube in float32 on the card and in
    float64 on the CPU; the card's result and H2 launches, and the CPU's
    result."""
    before = shear.launches
    got = run(torch.as_tensor(cube, dtype=torch.float32, device="cuda"))
    torch.cuda.synchronize()
    h2 = shear.launches - before
    return got, h2, run(torch.as_tensor(cube, dtype=torch.float64))


def _rel_to(got, ref):
    got = got.cpu().double().numpy()
    ref = ref.numpy()
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    return np.abs(got[fin] - ref[fin]).max() / np.abs(ref[fin]).max()


@pytest.mark.parametrize("opt_method", ["lsq", "l1"])
def test_invprob_andromeda_on_the_card(cuda_device, opt_method):
    import vip_tpu_torch.invprob as ip

    angles = np.linspace(-20, 20, 12)
    cube = _companion_cube(12, 40, angles, 8.5, 70.0, 20.0, seed=42)
    psf = _gaussian_stamp(8)
    got, h2, ref = _card_and_cpu(lambda c: ip.andromeda(
        cube=c, angle_list=angles, psf=psf, oversampling_fact=1.2,
        filtering_fraction=0.3, nsmooth_snr=8, precision=8,
        opt_method=opt_method, verbose=False), cube)
    errs = [_rel_to(g, r) for g, r in zip(got[:6], ref[:6])]
    print(f"ANDROMEDA {opt_method} on the card against the CPU float64 "
          f"mode: " + ", ".join(f"{e:.3e}" for e in errs))
    assert got[0].is_cuda and got[0].dtype == torch.float32 and h2 == 0
    assert max(errs) <= ANDROMEDA_CARD_TOL


@pytest.mark.parametrize("model", ["KLIP", "LOCI"])
def test_invprob_fmmf_on_the_card(cuda_device, monkeypatch, model):
    import vip_tpu_torch.invprob as ip

    angles = np.linspace(0, 60, 15)
    cube = _companion_cube(15, 40, angles, 6.0, 0.0, 10.0, seed=3)
    psf = _gaussian_stamp(11)
    psf /= psf.sum()
    monkeypatch.delenv("VIP_TPU_FMMF_BATCHED", raising=False)
    got, h2, ref = _card_and_cpu(lambda c: ip.fmmf(
        cube=c, angle_list=angles, psf=psf, fwhm=4.0, min_r=5, max_r=8,
        model=model, param={"ncomp": 5, "tolerance": 5e-3,
                            "delta_rot": 0.25}, crop=5, verbose=False),
        cube)
    errs = [_rel_to(g, r) for g, r in zip(got, ref)]
    print(f"FMMF {model} on the card (batched form): H2 {h2}; against the "
          f"CPU float64 mode (serial form) {errs[0]:.3e}, {errs[1]:.3e}")
    # 40² frames: H2 on N = 160; three annuli, each derotating its
    # residual cube and its model frames (one chunk of pixels) in one
    # chunk each: 3 launches a chunk
    assert h2 == 18
    assert max(errs) <= FMMF_CARD_TOL
    snr = got[1].cpu().numpy()
    peak = np.unravel_index(np.argmax(snr), snr.shape)
    assert np.hypot(peak[0] - 20, peak[1] - 26) <= 3


def test_invprob_fastpaco_on_the_card(cuda_device):
    import vip_tpu_torch.invprob as ip

    angles = np.linspace(0, 50, 8)
    cube = _companion_cube(8, 24, angles, 7.0, 45.0, 15.0, seed=5,
                           level=5.0)
    psf = _gaussian_stamp(9, fwhm=2.355)
    got, h2, ref = _card_and_cpu(lambda c: ip.FastPACO(
        cube=c, angles=angles, psf=psf, fwhm=2.0, pixscale=1.0).run(),
        cube)
    err = _rel_to(got[0], ref[0])
    print(f"FastPACO on the card against the CPU float64 mode: S/N {err:.3e}"
          f", flux {_rel_to(got[1], ref[1]):.3e}")
    assert got[0].is_cuda and got[0].dtype == torch.float32 and h2 == 0
    assert err <= PACO_CARD_TOL


# Slice 7, the 4-d IFS paths: tests/test_pca_4d.py's ifs_cube (4 channels
# x 8 frames x 40², speckles scaled with λ). Each entry point in float64
# on the card against the CPU float64 mode (the same float32 zoom canvas,
# float64 FFTs and SVDs in cuSOLVER and LAPACK: 1e-8 of max(|ref|, 1)),
# and in float32 (1e-4 of max(|ref|, 1)) with its H1 and H2 launches:
# every channel collapse of a whole cube is one H1 launch, (z, n, y, x)
# viewed as (z, n·y, x).
IFS_F64_TOL, IFS_F32_TOL = 1e-8, 1e-4
# PACO's maps after the resampling invert every cell's shrunk covariance
# (an LU in cuSOLVER and in LAPACK), which amplifies the last digits:
# measured 4.5e-8 of max|snr| in float64 on an H100 80GB HBM3 at 700 W;
# the resampled cube itself is held to IFS_F64_TOL
PACO_F64_TOL = 1e-6
# the 4-d contrast curve's throughput, float32 on the card against the CPU
# float64 mode (chip_smoke.py's IFS_CC_TOL, kernels against the plain
# route: ratios of aperture sums over frames that differ by float32
# rounding)
IFS_CC_TOL = 1e-3


def _ifs_inputs():
    from scipy.ndimage import gaussian_filter

    from vip_tpu_torch.preproc.rescaling import frame_rescaling

    rng = np.random.default_rng(9)
    z, n, size = 4, 8, 40
    wl = np.linspace(1.0, 1.3, z)
    scal = wl[-1] / wl
    speck = gaussian_filter(rng.standard_normal((size, size)), 2.0) * 5
    cube = np.empty((z, n, size, size))
    for ch in range(z):
        sp = frame_rescaling(torch.as_tensor(speck, device="cpu"),
                             scale=1 / scal[ch]).numpy()
        for fr in range(n):
            cube[ch, fr] = sp + gaussian_filter(
                rng.standard_normal((size, size)), 1.0) * 0.3
    return cube, np.linspace(0, 40, n), scal


def _ifs_cases():
    """(name, run(cube, angles, scal), (H1, H2) in float32)."""
    import vip_tpu_torch.psfsub as tps
    from vip_tpu_torch.preproc.rescaling import cube_rescaling_wavelengths

    loci = dict(fwhm=4, asize=8, radius_int=4, delta_sep=0.1, delta_rot=0.3,
                n_segments=1, verbose=False)
    return [
        # the channel collapse of all frames, then the temporal median
        ("pca single", lambda c, a, s: tps.pca(
            c, a, scale_list=s, ncomp=2, adimsdi="single",
            collapse_ifs="median", full_output=True, verbose=False), (2, 3)),
        ("pca double", lambda c, a, s: tps.pca(
            c, a, scale_list=s, ncomp=(2, 2), adimsdi="double",
            collapse_ifs="median", full_output=True, verbose=False), (2, 3)),
        # each channel's ADI (a median and one chunk), then their median
        ("pca per-channel", lambda c, a, s: tps.pca(
            c, a, ncomp=2, collapse_ifs="median", verbose=False), (5, 12)),
        # three truncations, each rescaled back (a median) and reduced
        ("pca grid", lambda c, a, s: tps.pca(
            c, a, scale_list=s, ncomp=(1, 3), adimsdi="single",
            verbose=False), (6, 9)),
        ("pca_annular sdi", lambda c, a, s: tps.pca_annular(
            c, a, scale_list=s, ncomp=(1, 2), fwhm=4, radius_int=6, asize=6,
            delta_sep=0.1, delta_rot=0.3, full_output=True, verbose=False),
         (1, 3)),
        # the channel medians of all frames, their collapse, the temporal
        # median and the final collapse: four launches for the cube
        ("median_sub fullfr", lambda c, a, s: tps.median_sub(
            c, a, scale_list=s, fwhm=4, full_output=True, verbose=False),
         (4, 3)),
        # three annuli: a median of the channel libraries and one of the
        # frame libraries each, beside the channel and final collapses
        ("median_sub annular", lambda c, a, s: tps.median_sub(
            c, a, scale_list=s, fwhm=4, mode="annular", radius_int=6,
            asize=4, delta_sep=0.1, delta_rot=0.3, nframes=None,
            full_output=True, verbose=False), (8, 3)),
        ("xloci double", lambda c, a, s: tps.xloci(
            c, a, scale_list=s, adimsdi="double", full_output=True, **loci),
         (2, 3)),
        # all channels at once: one chunk of the 32 residual frames, one
        # median of every channel's frames, then the channels' median
        ("pca_annulus", lambda c, a, s: tps.pca_annulus(
            c, a, 2, 6, 12, collapse_ifs="median"), (2, 3)),
        ("rescaling", lambda c, a, s: cube_rescaling_wavelengths(
            c[:, 0], s), (1, 0)),
        ("paco rescaling", _paco_rescaled, (0, 0)),
    ]


def _paco_rescaled(c, a, s):
    """FastPACO with ``rescaling_factor=2`` on the first channel: its
    resampled cube, then its S/N and flux maps."""
    import vip_tpu_torch.invprob as ip

    paco = ip.FastPACO(cube=c[0], angles=a,
                       psf=_gaussian_stamp(9, fwhm=2.355), fwhm=2.0,
                       pixscale=1.0, rescaling_factor=2.0)
    snr, flux = paco.run()
    return paco.cube, snr, flux


def _as_list(out):
    """The tensors of a result (a tensor or a tuple)."""
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o for o in out if isinstance(o, torch.Tensor)]


@pytest.mark.parametrize("case", range(11))
def test_ifs_entry_points_on_the_card(cuda_device, case):
    name, run, (n_h1, n_h2) = _ifs_cases()[case]
    cube, angles, scal = _ifs_inputs()
    ref = _as_list(run(torch.as_tensor(cube), angles, scal))
    vip_tpu_torch.set_device("cuda")
    try:
        got64 = _as_list(run(torch.as_tensor(cube, device="cuda"), angles,
                             scal))
        before = (median.launches, shear.launches)
        got32 = _as_list(run(torch.as_tensor(cube, dtype=torch.float32,
                                             device="cuda"), angles, scal))
        torch.cuda.synchronize()
        counts = (median.launches - before[0], shear.launches - before[1])
    finally:
        vip_tpu_torch.set_device("cpu")

    def rel(got, want):
        g, w = got.cpu().double().numpy(), want.double().numpy()
        fin = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), fin)
        return np.abs(g[fin] - w[fin]).max() / max(np.abs(w[fin]).max(),
                                                   1.0)

    e64s = [rel(g, r) for g, r in zip(got64, ref)]
    e64 = max(e64s)
    e32 = max(rel(g, r) for g, r in zip(got32, ref))
    print(f"{name} on the card: float64 {e64:.3e}, float32 {e32:.3e} "
          f"against the CPU float64 mode; float32 launches H1 {counts[0]}, "
          f"H2 {counts[1]}")
    assert got32[0].is_cuda and got32[0].dtype == torch.float32
    assert got64[0].is_cuda and got64[0].dtype == torch.float64
    if name == "paco rescaling":
        assert e64s[0] <= IFS_F64_TOL and max(e64s[1:]) <= PACO_F64_TOL
    else:
        assert e64 <= IFS_F64_TOL, name
    assert e32 <= IFS_F32_TOL, name
    assert counts == (n_h1, n_h2), name


def test_ifs_contrast_curve_on_the_card(cuda_device):
    """The 4-d contrast curve of the single ADI+mSDI pass, the small shape
    of chip_smoke.py's phase 18 curve (cut to every 20th frame there):
    its companions injected and reduced on the card in float32 through H1
    and H2, its throughput within IFS_CC_TOL of the CPU float64 mode's."""
    import vip_tpu_torch.psfsub as tps
    from vip_tpu_torch.fm import normalize_psf
    from vip_tpu_torch.metrics.contrcurve import _contrast_curve

    cube, angles, scal = _ifs_inputs()
    psf = np.stack([_gaussian_stamp(13, fwhm=4.0 / s) for s in scal])
    psfn = normalize_psf(psf, fwhm=list(4.0 / scal), verbose=False)
    kw = dict(nbranch=1, fc_rad_sep=3, plot=False, verbose=False,
              scale_list=scal, ncomp=2, adimsdi="single")
    ref = _contrast_curve(cube, angles, psfn, 4.0, 0.0075, 1e4, tps.pca,
                          **kw)[0]
    vip_tpu_torch.set_device(cuda_device)
    try:
        before = (median.launches, shear.launches)
        got = _contrast_curve(cube.astype(np.float32), angles, psfn, 4.0,
                              0.0075, 1e4, tps.pca, **kw)[0]
        counts = (median.launches - before[0], shear.launches - before[1])
    finally:
        vip_tpu_torch.set_device("cpu")
    thr, thr_ref = got["throughput"], ref["throughput"]
    print(f"IFS contrast curve on the card: {len(thr)} radii, throughput "
          f"{thr.min():.4f}..{thr.max():.4f}; against the CPU float64 mode "
          f"{np.abs(thr - thr_ref).max():.3e}; H1 {counts[0]}, "
          f"H2 {counts[1]}")
    assert counts[0] > 0 and counts[1] > 0
    assert np.all(np.isfinite(thr)) and 0 < thr.max() <= 1
    assert np.abs(thr - thr_ref).max() <= IFS_CC_TOL


def test_ifs_negfc_lnprob_on_the_card(cuda_device):
    """The 4-d NEGFC likelihood: two channels of the NEGFC cube, one flux
    a channel, the channels' medians collapsed by one more median."""
    import vip_tpu_torch.fm as tfm
    from vip_tpu_torch.ops.negfc_model import make_batched_lnprob

    cube, angles, psfn = _negfc_inputs()
    cube4 = np.stack([cube, 0.8 * cube])
    psf4 = np.stack([psfn, psfn])
    r, theta, f = NEGFC_TRUTH
    bounds = [(r - 2, r + 2), (theta - 10, theta + 10), (0, 5 * f),
              (0, 5 * f)]
    params = np.array([[r, theta, f, 0.8 * f], [r + 0.4, theta - 1.5, f,
                                                 f * 0.7],
                       [r - 0.6, theta + 2.0, f * 0.7, f]])
    args = (angles, psf4, 1, 8, r, theta, 1.0, 4.0, 0.0, 0.05 ** 2, bounds)
    kw = dict(collapse_ifs="median")
    ref = make_batched_lnprob(cube4, *args, **kw)(params).numpy()
    lnprob = make_batched_lnprob(
        torch.as_tensor(cube4, dtype=torch.float32, device=cuda_device),
        *args, **kw)
    before = (median.launches, shear.launches)
    got = lnprob(params).cpu().double().numpy()
    torch.cuda.synchronize()
    counts = (median.launches - before[0], shear.launches - before[1])
    err = np.max(np.abs(got - ref) / np.abs(ref))
    print(f"4-d NEGFC lnprob on the card: H1 {counts[0]}, H2 {counts[1]}; "
          f"against the CPU float64 mode {err:.3e}")
    # a median and one chunk (3 H2) a channel, then the channels' median
    assert counts == (3, 6)
    assert err <= NEGFC_TOL
    chi = tfm.chisquare(tuple(params[0]), torch.as_tensor(
        cube4, dtype=torch.float32, device=cuda_device), angles, psf4, 4.0,
        8, 1, (r, theta), 1)
    chi_ref = tfm.chisquare(tuple(params[0]), cube4, angles, psf4, 4.0, 8,
                            1, (r, theta), 1)
    assert abs(chi - chi_ref) <= NEGFC_TOL * abs(chi_ref)


# Slice 8a: the bad-pixel filters, stats, subsampling, cosmetics,
# randomized_svd_gpu and pca(smooth=). Each entry point in float64 on the
# card against the CPU float64 mode (1e-8 of max(|ref|, 1); the sigma
# filter's frames equal), and in float32 within the bound of slice 7's
# card tests (1e-4 of max(|ref|, 1)).
S8A_F64_TOL, S8A_F32_TOL = 1e-8, 1e-4


def _s8a_cube(n=12, size=40, seed=3):
    rng = np.random.default_rng(seed)
    cube = rng.standard_normal((n, size, size)) + 10.0
    nans = rng.random(cube.shape) < 0.01
    nans[:, 10:15, 20:24] = True
    cube[nans] = np.nan
    return cube


def _s8a_cases():
    """(name, run(cube), H1 launches in float32)."""
    import vip_tpu_torch.preproc as tpp
    import vip_tpu_torch.psfsub as tps
    import vip_tpu_torch.stats as tst
    import vip_tpu_torch.var as tv

    psf = tv.create_synth_psf(shape=(9, 9), fwhm=3)
    psf /= psf.sum()
    return [
        ("cube_correct_nan", lambda c: tpp.cube_correct_nan(c), 0),
        ("cube_subsample median", lambda c: tpp.cube_subsample(
            tpp.cube_correct_nan(c), 4, "median", verbose=False), 1),
        ("cube_subsample trimmean", lambda c: tpp.cube_subsample_trimmean(
            tpp.cube_correct_nan(c), 2, 5), 0),
        ("cube_filter_iuwt", lambda c: tv.cube_filter_iuwt(
            tpp.cube_correct_nan(c), coeff=4, rel_coeff=2), 0),
        ("frame_deconvolution", lambda c: tv.frame_deconvolution(
            tpp.cube_correct_nan(c)[0], psf, n_it=10), 0),
        # the median reference frame of each call: one H1 launch each
        ("cube_distance", lambda c: torch.stack([tst.cube_distance(
            tpp.cube_correct_nan(c), None, dist=d, plot=False) for d in
            ("sad", "mse", "pearson", "spearman", "ssim")]), 5),
        ("randomized_svd_gpu", lambda c: (lambda u, s, v: (s, v.T @ v))(
            *tps.randomized_svd_gpu(tpp.cube_correct_nan(c).reshape(
                c.shape[0], -1), 3)), 0),
    ]


@pytest.mark.parametrize("case", range(7))
def test_slice8a_entry_points_on_the_card(cuda_device, case):
    name, run, n_h1 = _s8a_cases()[case]
    cube = _s8a_cube()
    ref = _as_list(run(torch.as_tensor(cube)))
    vip_tpu_torch.set_device("cuda")
    try:
        got64 = _as_list(run(torch.as_tensor(cube, device="cuda")))
        before = median.launches
        got32 = _as_list(run(torch.as_tensor(cube, dtype=torch.float32,
                                             device="cuda")))
        torch.cuda.synchronize()
        n1 = median.launches - before
    finally:
        vip_tpu_torch.set_device("cpu")

    def rel(got, want):
        g, w = got.cpu().double().numpy(), want.double().numpy()
        return np.abs(g - w).max() / max(np.abs(w).max(), 1.0)

    e64 = max(rel(g, r) for g, r in zip(got64, ref))
    e32 = max(rel(g, r) for g, r in zip(got32, ref))
    print(f"{name} on the card: float64 {e64:.3e}, float32 {e32:.3e} "
          f"against the CPU float64 mode; float32 H1 launches {n1}")
    assert got32[0].is_cuda and got64[0].is_cuda
    assert e64 <= S8A_F64_TOL, name
    assert e32 <= S8A_F32_TOL, name
    assert n1 == n_h1, name


def test_sigma_filter_route_is_its_dense_plain_version(cuda_device):
    """A stalled clump beside a clump eroded over several sweeps and
    scattered pixels: the gathered route and the dense plain version give
    the same bits and sweep counts, and the float64 frames equal the
    CPU's."""
    from vip_tpu_torch.ops import badpix

    rng = np.random.default_rng(1)
    cube = rng.standard_normal((6, 64, 48)).astype(np.float32)
    bp = rng.random(cube.shape) < 0.01
    bp[:, 20:29, 10:19] = True
    bp[2] = True                          # stalled: three good pixels
    bp[2, 0, 0] = bp[2, 7, 7] = bp[2, 30, 30] = False
    for dtype in (torch.float32, torch.float64):
        c = torch.as_tensor(cube, dtype=dtype, device=cuda_device)
        b = torch.as_tensor(bp, device=cuda_device)
        out, nit = badpix._sigma_filter_gathered(c, b, 3)
        dense, dnit = badpix._sigma_filter_dense(c, b, 3)
        assert torch.equal(out.nan_to_num(7.0), dense.nan_to_num(7.0))
        assert torch.equal(nit, dnit)
        cpu, cnit = badpix._sigma_filter_gathered(c.cpu(), b.cpu(), 3)
        assert torch.equal(out.cpu(), cpu) and torch.equal(nit.cpu(), cnit)
    assert int(nit[2]) == 1 and len(set(nit.tolist())) > 1


def test_cube_subsample_median_is_one_h1_launch(cuda_device, monkeypatch):
    import vip_tpu_torch.preproc as tpp

    cube = torch.as_tensor(_s8a_cube(n=40, size=48, seed=5),
                           dtype=torch.float32, device=cuda_device)
    pa = np.linspace(0, 20, 40)
    before = median.launches
    out, angles = tpp.cube_subsample(cube, 6, "median", parallactic=pa,
                                     verbose=False)
    torch.cuda.synchronize()
    assert median.launches - before == 1
    _plain_route(monkeypatch)
    ref, ref_angles = tpp.cube_subsample(cube, 6, "median", parallactic=pa,
                                         verbose=False)
    assert median.launches - before == 1
    assert torch.equal(out.nan_to_num(7.0), ref.nan_to_num(7.0))
    np.testing.assert_array_equal(angles, ref_angles)
    c4 = torch.stack([cube, 2 * cube])
    before = median.launches
    monkeypatch.undo()
    tpp.cube_subsample(c4, 6, "median", verbose=False)
    assert median.launches - before == 1


def test_pca_smooth_on_the_card(cuda_device):
    """``smooth`` adds no launch: the same H1/H2 counts as without it, the
    frame equal to ``pca`` then ``frame_filter_lowpass``, and within the
    float32 bound of the CPU float64 frame."""
    import vip_tpu_torch.psfsub as tps
    from vip_tpu_torch.var import frame_filter_lowpass

    rng = np.random.default_rng(2)
    cube = rng.standard_normal((30, 64, 64))
    angles = np.linspace(0, 40, 30)
    ref = tps.pca(cube, angles, ncomp=3, smooth=2.0, verbose=False)
    c32 = torch.as_tensor(cube, dtype=torch.float32, device=cuda_device)
    counts = []
    frames = []
    for smooth in (None, 2.0):
        before = (median.launches, shear.launches)
        frames.append(tps.pca(c32, angles, ncomp=3, smooth=smooth,
                              verbose=False))
        torch.cuda.synchronize()
        counts.append((median.launches - before[0],
                       shear.launches - before[1]))
    assert counts[0] == counts[1] and counts[0][0] == 1 and counts[0][1] > 0
    low = frame_filter_lowpass(frames[0], mode="gauss", fwhm_size=2.0)
    assert torch.equal(frames[1], low)
    err = (frames[1].cpu().double() - ref).abs().max() / max(
        float(ref.abs().max()), 1.0)
    assert err <= S8A_F32_TOL


# Slice 8b: registration and recentering, bad pixels, bad frames. Each
# batched route against its per-frame loop on the card (float32: maps
# equal, frames within 1e-5 of max(|ref|, 1); the routes with an argmax or
# a stopping test in float64, where float32 rounding could move a
# decision), and each entry point in float64 on the card against the CPU
# float64 mode (1e-8 of max(|ref|, 1); shifts through host fits 1e-6 px).
S8B_F32_TOL, S8B_F64_TOL, S8B_FIT_TOL = 1e-5, 1e-8, 1e-6


def _s8b_stars(n=10, size=64, seed=4):
    """``n`` frames of unit noise with a Moffat star jittered by up to
    1.5 px, and the jitter."""
    from vip_tpu_torch.var.fit_2d import create_synth_psf

    rng = np.random.default_rng(seed)
    jit = rng.uniform(-1.5, 1.5, (n, 2))
    c = size // 2
    cube = np.stack([create_synth_psf("moff", (size, size), amplitude=300,
                                      fwhm=4, x_mean=c + dx, y_mean=c + dy)
                     for dy, dx in jit]) \
        + rng.standard_normal((n, size, size))
    return cube, jit


def _s8b_hot(n=6, size=64, seed=5):
    rng = np.random.default_rng(seed)
    cube = rng.standard_normal((n, size, size)) + 10
    cube[rng.random(cube.shape) < 0.005] += 40
    cube[:, 20:23, 30:33] += 30
    return cube


def _rel(got, want):
    g = got.detach().cpu().double().numpy()
    w = want.detach().cpu().double().numpy() if isinstance(
        want, torch.Tensor) else np.asarray(want, float)
    return np.abs(g - w).max() / max(np.abs(w).max(), 1.0)


def test_slice8b_registration_batch_is_the_frame_loop(cuda_device):
    from vip_tpu_torch.ops import registration as reg

    cube, _ = _s8b_stars()
    t = torch.as_tensor(cube, dtype=torch.float32, device=cuda_device)
    batch = reg.dft_registration_batch(t[0], t[1:], 100)
    rf = torch.fft.fft2(t[0])
    loop = torch.stack([reg.dft_registration(rf, torch.fft.fft2(f), 100)
                        for f in t[1:]])
    assert float((batch - loop).abs().max()) <= 0.01 + 1e-6
    mask = np.zeros(cube.shape[-2:], bool)
    mask[8:56, 8:56] = True
    mb = reg.masked_register_translation(t[0], t[1:], mask)
    for i in range(1, t.shape[0]):
        np.testing.assert_array_equal(
            reg.masked_register_translation(t[0], t[i], mask), mb[i - 1])


def test_slice8b_badpix_batches_are_the_frame_loops(cuda_device):
    from vip_tpu_torch.preproc import badpixremoval as bp

    cube = torch.as_tensor(_s8b_hot(), dtype=torch.float32,
                           device=cuda_device)
    n = cube.shape[0]
    zeros = torch.zeros(cube.shape, dtype=torch.bool, device=cuda_device)
    c = [32] * n
    # isolated, frame by frame
    got = bp._isolated_frames(cube, None, False, 3, 5, 5, 0, c, c, False,
                              True, zeros)
    ref = [torch.cat(o) for o in zip(*[bp._isolated_frames(
        cube[i:i + 1], None, False, 3, 5, 5, 0, [32], [32], False, True,
        zeros[i:i + 1]) for i in range(n)])]
    assert torch.equal(got[1], ref[1]) and _rel(got[0], ref[0]) <= \
        S8B_F32_TOL
    # clump
    got = bp._clump_frames(cube, c, c, [4.0] * n, 4.0, 0, zeros, zeros,
                           None, 15, False, True, False)
    ref = [torch.cat(o) for o in zip(*[bp._clump_frames(
        cube[i:i + 1], [32], [32], [4.0], 4.0, 0, zeros[i:i + 1],
        zeros[i:i + 1], None, 15, False, True, False) for i in range(n)])]
    assert torch.equal(got[1], ref[1]) and _rel(got[0], ref[0]) <= \
        S8B_F32_TOL
    # annuli: numpy's generator drawn in frame order by both
    np.random.seed(1)
    got = bp._ann_removal_frames(cube, c, c, [4.0] * n, 3.0, 0, zeros, zeros,
                                 50, None, 0.0, 60.0, None, False, False)
    np.random.seed(1)
    ref = [torch.cat(o) for o in zip(*[bp._ann_removal_frames(
        cube[i:i + 1], [32], [32], [4.0], 3.0, 0, zeros[i:i + 1],
        zeros[i:i + 1], 50, None, 0.0, 60.0, None, False, False)
        for i in range(n)])]
    assert torch.equal(got[1], ref[1]) and _rel(got[0], ref[0]) <= \
        S8B_F32_TOL
    # the FFT fill in float64: each frame's iterations and frame
    c64 = cube.double()
    masks = cube > 30
    res, _, its = bp._fft_fill_frames(c64, masks, 300, 1e3, 2, False)
    for i in range(n):
        r1, _, i1 = bp._fft_fill_frames(c64[i:i + 1], masks[i:i + 1], 300,
                                        1e3, 2, False)
        assert i1[0] == its[i]
        assert _rel(res[i], r1[0]) <= 1e-10


def test_slice8b_ifs_is_one_h1_launch(cuda_device, monkeypatch):
    """39 channels: the 38 residuals of each in one H1 launch with
    ``propagate=True``, bit-equal to the plain median on the same zooms;
    the batched zooms' residuals against the per-pair ``frame_rescaling``
    loop."""
    from vip_tpu_torch.preproc import badpixremoval as bp
    from vip_tpu_torch.preproc import rescaling

    rng = np.random.default_rng(7)
    z, s = 39, 48
    lbda = np.linspace(0.95, 1.35, z)
    yy, xx = np.mgrid[:s, :s]
    cube = np.stack([300 * np.exp(-((yy - 24) ** 2 + (xx - 24) ** 2)
                                  / (2 * (1.5 * lb) ** 2)) for lb in lbda])
    cube += rng.standard_normal(cube.shape)
    cube[5, 8:11, 8:11] += 2000
    t = torch.as_tensor(cube, dtype=torch.float32, device=cuda_device)
    scal = rescaling.find_scal_vector(t, lbda, [1] * z, nfp=2, fm="sum")
    monkeypatch.setattr(rescaling, "find_scal_vector", lambda *a, **k: scal)
    before = median.launches
    got = bp.cube_fix_badpix_ifs(t, lbda, mad=True, full_output=True,
                                 verbose=False)
    torch.cuda.synchronize()
    assert median.launches - before == 1
    _plain_route(monkeypatch)
    # the plain median on the same zooms: bit-equal to H1's
    same = bp.cube_fix_badpix_ifs(t, lbda, mad=True, full_output=True,
                                  verbose=False)
    assert median.launches - before == 1
    for g, r in zip(got, same):
        assert torch.equal(g, r)
    assert bool(got[1][5, 9, 9])
    # the per-pair frame_rescaling loop: the same residuals to rounding
    monkeypatch.setattr(bp, "_sdi_diffs_batched", lambda ch, sv, fv: bp.
                        _sdi_diffs_plain(ch, sv, fv, None, "vip-fft",
                                         "lanczos4"))
    ref = bp.cube_fix_badpix_ifs(t, lbda, mad=True, full_output=True,
                                 verbose=False)
    assert _rel(got[2], ref[2]) <= S8B_F32_TOL


def _s8b_cases():
    """(name, run(cube as a tensor), output indices compared as shifts)."""
    import vip_tpu_torch.preproc as tpp

    mask = np.zeros((64, 64), bool)
    mask[6:58, 6:58] = True
    return [
        ("cube_recenter_dft_upsampling", lambda c: tpp.
         cube_recenter_dft_upsampling(c, subi_size=9, full_output=True,
                                      verbose=False, plot=False), (1, 2)),
        ("dft_upsampling mask", lambda c: tpp.cube_recenter_dft_upsampling(
            c, mask=mask, full_output=True, verbose=False, plot=False),
         (1, 2)),
        ("cube_recenter_2dfit", lambda c: tpp.cube_recenter_2dfit(
            c, subi_size=9, model="moff", full_output=True, verbose=False,
            plot=False), (1, 2)),
        ("cube_recenter_via_speckles", lambda c: tpp.
         cube_recenter_via_speckles(c, subframesize=31, alignment_iter=2,
                                    plot=False, full_output=True), (3, 4)),
        ("cube_fix_badpix_clump", lambda c: tpp.cube_fix_badpix_clump(
            c + 10, full_output=True, verbose=False), ()),
        ("cube_fix_badpix_annuli", lambda c: (np.random.seed(2), tpp.
                                              cube_fix_badpix_annuli(
            c + 10, 4, sig=3.0, full_output=True, verbose=False))[1], ()),
        ("cube_fix_badpix_interp fft", lambda c: tpp.cube_fix_badpix_interp(
            c, c > 100, mode="fft", nit=100, tol=1e-3), ()),
        ("cube_detect_badfr_ellipticity", lambda c: tpp.
         cube_detect_badfr_ellipticity(c, 4, crop_size=20, plot=False,
                                       verbose=False), (0, 1)),
    ]


@pytest.mark.parametrize("case", range(8))
def test_slice8b_entry_points_on_the_card(cuda_device, case):
    name, run, shift_idx = _s8b_cases()[case]
    cube, _ = _s8b_stars()
    ref = run(torch.as_tensor(cube))
    got = run(torch.as_tensor(cube, device=cuda_device))
    ref = list(ref) if isinstance(ref, tuple) else [ref]
    got = list(got) if isinstance(got, tuple) else [got]
    for k, (g, r) in enumerate(zip(got, ref)):
        if k in shift_idx:
            np.testing.assert_allclose(np.asarray(g, float),
                                       np.asarray(r, float), rtol=0,
                                       atol=S8B_FIT_TOL, err_msg=name)
        elif isinstance(r, torch.Tensor):
            assert g.device == cuda_device or g.is_cuda, name
            assert _rel(g, r) <= S8B_F64_TOL, (name, k, _rel(g, r))


# ----------------------------------------------------------------------
# Slices 8c and 9: the batched warps, rotate_fft_batch, the disk map

# a batched warp against its per-frame loop on the card (the same
# element-wise arithmetic), and the float32 card runs against float64
# ones (the bilinear float32 bound of tests/test_torch_imlibs.py)
S8C_LOOP_TOL, S8C_F32_TOL = 1e-6, 1e-4


def _s8c_frames(n=6, size=48, seed=31):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size)).astype(np.float32)


@pytest.mark.parametrize("imlib,interpolation", [
    ("opencv", "lanczos4"), ("opencv", "bicubic"), ("opencv", "bilinear"),
    ("opencv", "nearneig"), ("skimage", "biquintic"),
    ("skimage", "biquadratic"), ("tpu-interp", "bicubic")])
def test_slice8c_warps_are_the_frame_loops(cuda_device, imlib,
                                           interpolation):
    from vip_tpu_torch.preproc.derotation import cube_derotate, frame_rotate

    cube = torch.as_tensor(_s8c_frames(), device=cuda_device)
    angles = np.linspace(-70, 130, cube.shape[0])
    kw = dict(imlib=imlib, interpolation=interpolation)
    got = cube_derotate(cube, angles, **kw)
    assert got.is_cuda and got.dtype == torch.float32
    if imlib == "tpu-interp":
        loop = torch.cat([cube_derotate(cube[i:i + 1], angles[i:i + 1], **kw)
                          for i in range(cube.shape[0])])
    else:
        loop = torch.stack([frame_rotate(cube[i], -angles[i], **kw)
                            for i in range(cube.shape[0])])
    assert _rel(got, loop) <= S8C_LOOP_TOL
    f64 = cube_derotate(cube.double(), angles, **kw)
    assert _rel(got, f64) <= S8C_F32_TOL


def test_slice8c_shift_and_resize_on_the_card(cuda_device):
    from vip_tpu_torch.preproc.recentering import cube_shift, frame_shift
    from vip_tpu_torch.preproc.rescaling import cube_px_resampling

    cube = torch.as_tensor(_s8c_frames(), device=cuda_device)
    sy = np.linspace(-2.3, 1.9, cube.shape[0])
    sx = np.linspace(1.7, -0.6, cube.shape[0])
    kw = dict(imlib="opencv", interpolation="lanczos4", border_mode="reflect")
    got = cube_shift(cube, sy, sx, **kw)
    loop = torch.stack([frame_shift(cube[i], sy[i], sx[i], **kw)
                        for i in range(cube.shape[0])])
    assert got.is_cuda and _rel(got, loop) <= S8C_LOOP_TOL
    assert _rel(got, cube_shift(cube.double(), sy, sx, **kw)) <= S8C_F32_TOL
    # 'ndimage-interp' (host scipy; chip_smoke.py shifts 50 frames of 512²)
    kw = dict(imlib="ndimage-interp", interpolation="biquintic")
    got = cube_shift(cube, sy, sx, **kw)
    assert got.is_cuda and got.dtype == torch.float32
    assert _rel(got, cube_shift(cube.double(), sy, sx, **kw)) <= S8C_F32_TOL
    for scale in (0.5, 1.37):
        out = cube_px_resampling(cube, scale, imlib="opencv", verbose=False)
        ref = cube_px_resampling(cube.double(), scale, imlib="opencv",
                                 verbose=False)
        assert out.is_cuda and _rel(out, ref) <= S8C_F32_TOL


@pytest.mark.parametrize("N", [256, 2048])
def test_slice8c_rotate_fft_batch_runs_h3(cuda_device, N):
    """rotate_fft_batch on CUDA float32 canvases that H3 takes is H3,
    within ROT_TOL of its plain version; a float64 batch is the plain
    version."""
    from vip_tpu_torch.ops.fft import rotate_fft_batch

    canv = torch.zeros((3, N, N), device=cuda_device)
    canv[:, N // 4:3 * N // 4, N // 4:3 * N // 4] = torch.as_tensor(
        _s8c_frames(3, N // 2, 32), device=cuda_device)
    angles = torch.tensor([12.5, -100.0, 200.0])
    before = shear.small_launches
    got = rotate_fft_batch(canv, angles)
    assert shear.small_launches == before + 3
    ref = rotate_fft_small_plain(canv, angles)
    assert _rel(got, ref) <= ROT_TOL
    f64 = rotate_fft_batch(canv.double(), angles)
    assert shear.small_launches == before + 3
    assert _rel(got, f64) <= ROT_TOL


def test_slice8c_edge_blend_on_the_card(cuda_device):
    from vip_tpu_torch.preproc.derotation import (_prepad_placement,
                                                  cube_derotate, frame_rotate)

    cube = torch.as_tensor(_s8c_frames(4, 64), device=cuda_device)
    angles = np.array([10.0, -35.0, 95.0, 170.0])
    ny, nx = _prepad_placement(64, 64)[:2]
    draws = torch.randn((4, ny, nx), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(1))
    before = shear.small_launches
    got = cube_derotate(cube, angles, edge_blend="noise+interp", draws=draws)
    assert shear.small_launches > before            # 256² canvases: H3
    loop = torch.stack([frame_rotate(cube[i], -angles[i],
                                     edge_blend="noise+interp",
                                     draws=draws[i]) for i in range(4)])
    assert _rel(got, loop) <= ROT_TOL
    f64 = cube_derotate(cube.double(), angles, edge_blend="noise+interp",
                        draws=draws.double())
    assert _rel(got, f64) <= 1e-4


def test_slice9_disk_map_float32_against_float64(cuda_device):
    from vip_tpu_torch.fm import ScatteredLightDisk

    disk = ScatteredLightDisk(
        nx=128, ny=128, distance=50., itilt=70., pxInArcsec=0.05,
        density_dico={'name': '2PowerLaws', 'ain': 10, 'aout': -5, 'a': 40,
                      'e': 0.1, 'ksi0': 1., 'gamma': 2., 'beta': 1.},
        spf_dico={'name': 'HG', 'g': 0.4, 'polar': False})
    m64 = disk.compute_scattered_light(halfNbSlices=25, device=cuda_device)
    m32 = disk.compute_scattered_light(halfNbSlices=25, device=cuda_device,
                                       dtype=torch.float32)
    cpu = disk.compute_scattered_light(halfNbSlices=25, device="cpu")
    assert m64.is_cuda and m32.dtype == torch.float32
    peak = float(cpu.max())
    assert float((m64.cpu() - cpu).abs().max()) <= 1e-12 * peak
    assert float((m32.double().cpu() - cpu).abs().max()) <= 1e-4 * peak


def test_slice9_chisquare_fd_on_the_card(cuda_device):
    """cube_inject_fakedisk and chisquare_fd on a CUDA cube: H2 derotates
    the model, H1 takes pca's median, and the χ² is the CPU float64 one
    within float32 rounding of the PCA (1e-3)."""
    from vip_tpu_torch.fm import chisquare_fd, cube_inject_fakedisk

    rng = np.random.default_rng(33)
    n, size = 40, 64
    angles = np.linspace(0, 60, n)
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot((yy - 32) / 0.4, xx - 32)
    disk = np.exp(-((r - 18) / 3.0) ** 2)
    noise = rng.standard_normal((n, size, size))
    cube = noise + 5 * np.asarray(cube_inject_fakedisk(disk, angles))
    mask = (np.hypot(yy - 32, xx - 32) > 8) & (np.hypot(yy - 32, xx - 32) < 28)
    args = ((5.0,), None, angles, disk, mask, (0.0, 0.0, 0.0, 1.0),
            (1, 1, 1, 1, 0))
    opts = {"ncomp": 5, "verbose": False}
    ref = chisquare_fd(args[0], torch.as_tensor(cube), *args[2:],
                       algo_options=opts, imlib="vip-fft")
    before = (median.launches, shear.launches)
    got = chisquare_fd(args[0], torch.as_tensor(cube, dtype=torch.float32,
                                                device=cuda_device),
                       *args[2:], algo_options=opts, imlib="vip-fft")
    assert median.launches > before[0] and shear.launches > before[1]
    assert abs(got - ref) <= 1e-3 * ref


@pytest.fixture
def on_the_card(cuda_device):
    """Numpy input to the card for one test (the module runs on the CPU)."""
    vip_tpu_torch.set_device(cuda_device)
    try:
        yield cuda_device
    finally:
        vip_tpu_torch.set_device("cpu")


def _s10_dataset(n=40, size=64, seed=41):
    """A noise cube with a Gaussian PSF, as host numpy float64."""
    rng = np.random.default_rng(seed)
    cube = rng.standard_normal((n, size, size))
    yy, xx = np.mgrid[:13, :13]
    psf = np.exp(-((yy - 6) ** 2 + (xx - 6) ** 2) / (2 * (4 / 2.355) ** 2))
    return cube, np.linspace(0, 70, n), psf


def test_slice10_dataset_from_numpy_lands_on_the_card(on_the_card):
    from vip_tpu_torch.objects import Dataset

    cube, angles, psf = _s10_dataset()
    ds = Dataset(cube=cube, angles=angles, psf=psf, fwhm=4, px_scale=0.027)
    assert ds.cube.is_cuda and ds.cube.dtype == torch.float32
    assert ds.psf.is_cuda and isinstance(ds.angles, np.ndarray)
    ds.normalize_psf(fit_fwhm=True, verbose=False)
    assert ds.psfn.is_cuda and ds.psfn.dtype == torch.float32
    copy = ds.copy()
    assert copy.cube.is_cuda and torch.equal(copy.cube, ds.cube)


def test_slice10_pppca_classic_is_pca_through_h1_h2(on_the_card):
    from vip_tpu_torch.objects import Dataset, MedianBuilder, PCABuilder
    from vip_tpu_torch.psfsub import median_sub, pca

    cube, angles, psf = _s10_dataset()
    ds = Dataset(cube=cube, angles=angles, psf=psf, fwhm=4, px_scale=0.027)
    before = (median.launches, shear.launches)
    obj = PCABuilder(dataset=ds, ncomp=5, verbose=False).build()
    obj.run(verbose=False)
    assert median.launches > before[0] and shear.launches > before[1]
    assert obj.frame_final.is_cuda
    direct = pca(cube=ds.cube, angle_list=ds.angles, ncomp=5, fwhm=4,
                 full_output=True, verbose=False)
    assert torch.equal(obj.frame_final, direct[0])
    obj = MedianBuilder(dataset=ds, verbose=False).build()
    obj.run()
    direct = median_sub(ds.cube, ds.angles, fwhm=4, full_output=True,
                        verbose=False)
    assert torch.equal(obj.frame_final, direct[2])


def test_slice10_decode_into_pinned_memory(cuda_device, tmp_path):
    """The lazy HDU decodes into a pinned tensor, bit for bit the plain
    decode; ``pca_incremental`` through that route equals its float64
    lazy HDU's (decoded, then cast to float32 and pinned) bit for bit."""
    from vip_tpu_torch.fits import _native, open_fits, write_fits
    from vip_tpu_torch.psfsub.utils_pca import pca_incremental

    cube = np.random.default_rng(42).standard_normal((60, 64, 64))
    path = str(tmp_path / "cube.fits")
    write_fits(path, cube, verbose=False)
    lazy = open_fits(path, return_memmap=True)
    buf = torch.empty((20, 64 * 64), dtype=torch.float32, pin_memory=True)
    lazy._read_frames(10, 30, out=buf)
    hdu = lazy._hdu
    want = _native._decode_plain(path, hdu["offset"], hdu["shape"],
                                 hdu["bitpix"], 1.0, 0.0, np.float32)
    assert buf.is_pinned()
    assert buf.numpy().tobytes() == want[10:30].tobytes()
    vip_tpu_torch.set_device(cuda_device)
    try:
        pinned = pca_incremental(lazy, np.linspace(0, 60, 60), batch=20,
                                 ncomp=3, verbose=False)
        other = pca_incremental(open_fits(path, return_memmap=True,
                                          precision=np.float64),
                                np.linspace(0, 60, 60), batch=20, ncomp=3,
                                verbose=False)
    finally:
        vip_tpu_torch.set_device("cpu")
    assert np.array_equal(pinned, other)


def test_slice10_evalroc_on_the_card(on_the_card):
    from vip_tpu_torch.metrics import EvalRoc
    from vip_tpu_torch.objects import Dataset, MedianBuilder, PCABuilder

    cube, angles, psf = _s10_dataset(n=20)
    ds = Dataset(cube=cube, angles=angles, psf=psf / psf.sum(), fwhm=4,
                 px_scale=0.1)
    roc = EvalRoc(ds, plsc=0.1, n_injections=2, inrad=8, outrad=14,
                  dist_flux=("uniform", 40, 60))
    roc.add_algo("medsub", MedianBuilder(dataset=ds, verbose=False).build(),
                 "-", "b", thresholds=[1, 2, 3])
    roc.add_algo("pca", PCABuilder(dataset=ds, ncomp=3, verbose=False)
                 .build(), "-", "r", thresholds=[1, 2, 3])
    roc.inject_and_postprocess(rng=np.random.RandomState(0))
    roc.compute_tpr_fps()
    for m in roc.methods:
        assert all(f.is_cuda for f in m["frames"])
        assert len(m["detections"]) == 2


def test_slice10_pp_classes_on_the_card(on_the_card, tmp_path):
    """The PP classes whose full-width runs chip_smoke.py's phase 22 cuts
    (annular PCA to 512 frames, annular NMF, LLSG and LOCI to phase 15's
    frames, the save to 50 frames), on a small cube on the card: each
    object's frame bit-equal to its function's; ``Dataset.save`` and
    ``load`` round trip bit for bit, the cube back on the card."""
    from vip_tpu_torch import psfsub
    from vip_tpu_torch.objects import (Dataset, LLSGBuilder, LOCIBuilder,
                                       NMFBuilder, PCABuilder)

    cube, angles, psf = _s10_dataset(n=30)
    ds = Dataset(cube=cube, angles=angles, psf=psf, fwhm=4, px_scale=0.027)
    pos = Dataset(cube=ds.cube - ds.cube.min() + 1.0, angles=angles, fwhm=4,
                  px_scale=0.027)
    ann = dict(ncomp=3, asize=4, delta_rot=(0.1, 1), n_segments=1)
    nmf_ann = dict(ncomp=3, radius_int=8, asize=4, handle_neg="subtr_min")
    llsg = dict(rank=3, thresh=1, max_iter=5, random_seed=10, fwhm=4)
    loci = dict(fwhm=4, asize=4, n_segments="auto", metric="correlation",
                radius_int=8, dist_threshold=90, delta_rot=0.5,
                optim_scale_fact=3, solver="lstsq", tol=0.01)
    cases = [
        (PCABuilder(dataset=ds, verbose=False, **ann),
         dict(runmode="annular", verbose=False),
         lambda: psfsub.pca_annular(ds.cube, angles, fwhm=4,
                                    full_output=True, verbose=False,
                                    **ann)[2]),
        (NMFBuilder(dataset=pos, verbose=False, **nmf_ann),
         dict(runmode="annular"),
         lambda: psfsub.nmf_annular(pos.cube, angles, verbose=False,
                                    **nmf_ann)),
        (LLSGBuilder(dataset=ds, verbose=False, **llsg), {},
         lambda: psfsub.llsg(ds.cube, angles, verbose=False, **llsg)),
        (LOCIBuilder(dataset=ds, verbose=False, **loci), {},
         lambda: psfsub.xloci(ds.cube, angles, verbose=False, **loci)),
    ]
    for builder, run_kw, direct in cases:
        obj = builder.build()
        obj.run(**run_kw)
        ref = direct()
        ref = ref[0] if isinstance(ref, tuple) else ref
        assert obj.frame_final.is_cuda, type(obj).__name__
        assert torch.equal(obj.frame_final, ref), type(obj).__name__
    path = str(tmp_path / "dataset")
    ds.normalize_psf(fit_fwhm=True, verbose=False)
    ds.save(path)
    back = Dataset.load(path)
    for key in ("cube", "psf", "psfn"):
        assert getattr(back, key).is_cuda
        assert torch.equal(getattr(back, key), getattr(ds, key)), key
    assert np.array_equal(back.angles, ds.angles)


@pytest.fixture
def nccl_mesh(on_the_card):
    """A one-rank NCCL group of this process on the card, and its mesh;
    the group is destroyed after the test."""
    import torch.distributed as dist

    from vip_tpu_torch.config import frame_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    mesh = frame_mesh()
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_slice11_nccl_world_one_sharded_pca_adi(nccl_mesh):
    """The sharded PCA-ADI on a one-rank NCCL mesh against the port's
    pipeline on the same card, mean and median, through H1 and H2."""
    import torch.distributed as dist

    from vip_tpu_torch.psfsub.sharded import (make_sharded_median_adi,
                                              make_sharded_pca_adi,
                                              sharded_pca_adi)

    assert dist.get_backend(nccl_mesh.get_group()) == "nccl"
    assert nccl_mesh.size() == 1
    cube, angles, _ = _s10_dataset()
    cube_t = torch.as_tensor(cube, dtype=torch.float32, device="cuda")
    for collapse in ("mean", "median"):
        before = (median.launches, shear.launches)
        if collapse == "mean":
            got = torch.as_tensor(sharded_pca_adi(cube, angles, ncomp=5,
                                                  mesh=nccl_mesh))
        else:
            got = make_sharded_pca_adi(nccl_mesh, 5, collapse="median")(
                cube, angles).cpu()
        assert shear.launches > before[1]
        assert (median.launches > before[0]) == (collapse == "median")
        ref = pipeline.pca_adi_pipeline(cube_t, angles, ncomp=5,
                                        method="eigen",
                                        collapse=collapse).cpu()
        assert (got - ref).abs().max() <= 1e-5 * max(ref.abs().max(), 1.0)
    got = make_sharded_median_adi(nccl_mesh)(cube, angles).cpu()
    ref = pipeline.median_adi_pipeline(cube_t, angles).cpu()
    assert (got - ref).abs().max() <= 1e-5 * max(ref.abs().max(), 1.0)


def test_slice11_dryrun_two_gloo_ranks_on_the_card(cuda_device):
    """``dryrun_multichip`` with 2 gloo ranks sharing the card: every
    sharded entry point, with H1 and H2 launched in the ranks."""
    from vip_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(2, backend="gloo", device="cuda:0")
    assert out["device"] == "cuda:0"
    assert out["pca_adi median"]["H1"] > 0 and out["pca_adi"]["H2"] > 0


def test_slice12_get_pca_coeffs_float32_against_float64(cuda_device):
    """``get_pca_coeffs`` of a small cube on the card in float32 against
    the same call in float64 on the card, host numpy out."""
    from vip_tpu_torch.ops.linalg import svd_top
    from vip_tpu_torch.psfsub.pca_fullfr import get_pca_coeffs

    cube = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (60, 64, 64)), dtype=torch.float32, device=cuda_device)
    pcs = svd_top(cube.reshape(60, -1), 8, method="eigen")
    for scaling, mask in ((None, None), ("temp-mean", 6),
                          ("spat-standard", None)):
        got = get_pca_coeffs(cube, pcs, 8, scaling, mask, verbose=False)
        ref = get_pca_coeffs(cube.double(), pcs.double(), 8, scaling, mask,
                             verbose=False)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert got.shape == (8, 60)
        scale = max(np.abs(ref).max(), 1.0)
        assert np.abs(got - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("size", [64, 63])
def test_slice12_tensor_rotate_fft_float32_against_float64(cuda_device,
                                                          size):
    """VIP's torch rotation on the card: float32 within 1e-5 of
    max(|ref|, 1) of float64, at the angles of chip_smoke.py's phase 24;
    numpy input lands on the card in float32."""
    from vip_tpu_torch.preproc.derotation import tensor_rotate_fft

    frame = np.random.default_rng(size).standard_normal((1, size, size))
    f32 = torch.as_tensor(frame, dtype=torch.float32, device=cuda_device)
    for angle in (0.0, 30.0, 60.0, 135.0, 300.0):
        got = tensor_rotate_fft(f32, angle)
        ref = tensor_rotate_fft(f32.double(), angle)
        assert got.is_cuda and got.dtype == torch.float32
        assert got.shape == (1, size, size)
        scale = max(float(ref.abs().max()), 1.0)
        assert float((got.double() - ref).abs().max()) <= 1e-5 * scale
    vip_tpu_torch.set_device(cuda_device)
    try:
        out = tensor_rotate_fft(frame, 30.0)
    finally:
        vip_tpu_torch.set_device("cpu")
    assert out.is_cuda and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# K5: the batched one-sided Jacobi SVD of small matrices (ops.linalg.svd's
# route for CUDA float32 matrices of sides <= 64)
# ---------------------------------------------------------------------------
def _r_factors(batch, n, seed, device):
    """R factors of (batch, 8n, n) tall matrices with a decaying spectrum,
    as the double pass's spectral QR makes them (upper triangular)."""
    g = torch.Generator().manual_seed(seed)
    M = torch.randn((batch, 8 * n, n), generator=g, dtype=torch.float64)
    M = M * torch.logspace(2, -2, n, dtype=torch.float64)
    return torch.linalg.qr(M)[1].to(device=device, dtype=torch.float32)


def _reconstruction(U, S, Vh, A):
    """max |U S Vh - A| / max |A|, in float64."""
    A64 = A.double()
    rec = (U.double() * S.double()[..., None, :]) @ Vh.double()
    return float((rec - A64).abs().max() / A64.abs().max())


def _projector(X):
    return X @ X.mT


@pytest.mark.parametrize("batch,n", [(100, 39), (1, 61)])
def test_jacobi_kernel_against_plain_and_gesvd(cuda_device, batch, n):
    """K5 on the double pass's shape (100 R factors of 39 rows) and on the
    NACO replica's (one of 61): singular values within 1e-6 of the
    largest and the top-5 projectors within 1e-4 of its plain version's,
    every matrix converged, orthonormal factors, and a reconstruction as
    close as gesvd's (twice it, or 1e-6)."""
    from vip_tpu_torch.ops.linalg import svd_jacobi, svd_jacobi_plain

    A = _r_factors(batch, n, n, cuda_device)
    U, S, Vh, info = svd_jacobi(A, with_info=True)
    Up, Sp, Vhp, infop = svd_jacobi_plain(A, with_info=True)
    Ug, Sg, Vhg = torch.linalg.svd(A, full_matrices=False, driver="gesvd")
    assert bool((info > 0).all()) and bool((infop > 0).all())
    scale = S[..., :1]
    assert float(((S - Sp).abs() / scale).max()) <= 1e-6
    for X, Xp in ((U[..., :5], Up[..., :5]), (Vh[..., :5, :].mT,
                                              Vhp[..., :5, :].mT)):
        assert float((_projector(X) - _projector(Xp)).abs().max()) <= 1e-4
    eye = torch.eye(n, device=cuda_device)
    assert float((U.mT @ U - eye).abs().max()) <= 1e-5
    assert float((Vh @ Vh.mT - eye).abs().max()) <= 1e-5
    rec, rec_g = _reconstruction(U, S, Vh, A), _reconstruction(Ug, Sg, Vhg,
                                                               A)
    s64 = torch.linalg.svd(A.double()).S
    print(f"K5 ({batch}, {n}, {n}): sweeps {int(info.min())}-"
          f"{int(info.max())}; reconstruction {rec:.3e} (gesvd {rec_g:.3e});"
          f" singular values from float64 "
          f"{float(((S - s64).abs() / s64[..., :1]).max()):.3e} (gesvd "
          f"{float(((Sg - s64).abs() / s64[..., :1]).max()):.3e})")
    assert rec <= max(2 * rec_g, 1e-6)


def test_jacobi_launches_once_per_batched_call(cuda_device):
    """``ops.linalg.svd`` of a CUDA float32 batch of small matrices is one
    K5 launch, whatever the batch's shape; ``svd_top``'s lapack route
    through the QR is one more."""
    from vip_tpu_torch.ops import linalg

    linalg.jacobi_launches = 0
    A = _r_factors(100, 39, 1, cuda_device)
    linalg.svd(A)
    assert linalg.jacobi_launches == 1
    linalg.svd(A.reshape(4, 25, 39, 39))
    assert linalg.jacobi_launches == 2
    linalg.svd(A[0, :17])                       # one wide matrix
    assert linalg.jacobi_launches == 3
    M = torch.randn((10, 39, 2000), device=cuda_device)
    linalg.svd_top(M, 3, method="lapack")
    assert linalg.jacobi_launches == 4


@pytest.mark.parametrize("shape,dtype,full", [
    ((65, 65), torch.float32, False), ((3, 39, 65), torch.float32, False),
    ((10, 39, 39), torch.float64, False), ((10, 39, 39), torch.float32,
                                           True)],
    ids=["65x65", "39x65", "float64", "full_matrices"])
def test_jacobi_no_launch_outside_its_route(cuda_device, shape, dtype, full):
    """A side over 64, float64 or the full factors stay on gesvd: no K5
    launch, and the kernel's wrapper refuses them rather than fall back."""
    from vip_tpu_torch.ops import linalg

    A = torch.randn(shape, dtype=dtype, device=cuda_device)
    linalg.jacobi_launches = 0
    U, S, Vh = linalg.svd(A, full_matrices=full)
    ref = torch.linalg.svd(A, full_matrices=full, driver="gesvd")
    assert linalg.jacobi_launches == 0
    assert torch.equal(S, ref.S)
    if not full:
        with pytest.raises(ValueError):
            linalg.svd_jacobi(A)
    assert linalg.jacobi_launches == 0


@pytest.mark.parametrize("shape", [(40, 17), (17, 40), (2, 3, 39, 39),
                                   (1, 1), (5, 1, 64), (64, 64)])
def test_jacobi_output_layout(cuda_device, shape):
    """K5's factors have ``torch.linalg.svd(full_matrices=False)``'s
    shapes, dtype, device and contiguity, singular values in descending
    order, and rebuild the matrix, tall, wide and batched."""
    from vip_tpu_torch.ops import linalg

    A = torch.randn(shape, device=cuda_device)
    U, S, Vh = linalg.svd(A)
    ref = torch.linalg.svd(A, full_matrices=False, driver="gesvd")
    for got, want in zip((U, S, Vh), ref):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert got.device == A.device and got.is_contiguous()
    assert bool((S[..., :-1] >= S[..., 1:]).all())
    assert _reconstruction(U, S, Vh, A) <= 1e-5


def _ifs_like(n, p, device, seed):
    """A (n, p) float32 matrix with an IFS sequence's spectrum: 60 real
    components falling from 4e6 to 3e4 (as the single pass's 3900 rows
    do) over white noise of 1 (singular values ~sqrt(p))."""
    g = torch.Generator(device=device).manual_seed(seed)
    k0 = 60
    U = torch.linalg.qr(torch.randn((n, k0), generator=g, device=device,
                                    dtype=torch.float64))[0]
    V = torch.linalg.qr(torch.randn((p, k0), generator=g, device=device,
                                    dtype=torch.float64))[0]
    s = torch.logspace(math.log10(4e6), math.log10(3e4), k0,
                       dtype=torch.float64, device=device)
    M = ((U * s) @ V.mT).float()
    return M.add_(torch.randn((n, p), generator=g, device=device))


@pytest.mark.parametrize("ncomp", [5, 20])
def test_svd_top_subspace_route_at_the_single_pass(cuda_device, ncomp):
    """``svd_top(lapack)`` of a 3900 x 84100 float32 matrix, the single
    pass's shape, takes the top-ncomp route (one matrix converged, no
    gesvd) and its principal components' projector lies as close to
    float64's (QR and gesvd in float64) as the gesvd route's does: within
    twice its distance, or 1e-6."""
    from vip_tpu_torch.ops import linalg

    M = _ifs_like(3900, 84100, cuda_device, 22)
    Q64, R64 = torch.linalg.qr(M.double().mT)
    Ur64 = torch.linalg.svd(R64, driver="gesvd")[0]
    ref = (Q64 @ Ur64[:, :ncomp]).mT
    del Q64, R64

    def dist(V):
        # largest principal angle's sine between span(V) and span(ref)
        V = V.double()
        return float(torch.linalg.matrix_norm(
            V.mT - ref.mT @ (ref @ V.mT), ord=2))

    linalg.subspace_matrices = 0
    V = linalg.svd_top(M, ncomp)
    assert linalg.subspace_matrices == 1
    keep = linalg.SUBSPACE_SVD_MIN_SIDE
    linalg.SUBSPACE_SVD_MIN_SIDE = 10 ** 9
    try:
        V_gesvd = linalg.svd_top(M, ncomp)
    finally:
        linalg.SUBSPACE_SVD_MIN_SIDE = keep
    assert linalg.subspace_matrices == 1
    d, d_gesvd = dist(V), dist(V_gesvd)
    print(f"svd_top lapack 3900x84100 ncomp {ncomp}: subspace route "
          f"{d:.3e} from float64, gesvd route {d_gesvd:.3e}")
    assert V.shape == (ncomp, 84100) and V.dtype == torch.float32
    assert d <= max(2 * d_gesvd, 1e-6)

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips on a host without a
CUDA card. The file imports neither jax nor vip_tpu, so it also runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips the repository's conftest files, which set up
jax for the vip_tpu tests.)
"""

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

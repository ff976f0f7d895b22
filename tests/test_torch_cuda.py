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

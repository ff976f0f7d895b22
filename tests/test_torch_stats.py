"""The port's ``stats`` subpackage against vip_tpu, on the CPU at float64.

- ``sigma_filter`` / ``cube_sigma_filter``: equal frames; the 3x3 window
  and 3 neighbours forced whatever is passed; a writeable numpy frame
  corrected in place; frames under 3 px through the host loop.
- ``clip_array``: equal index tuples, global and neighbour statistics,
  MAD, ``min_std``, a bad-pixel map, ``out_good``, ``half_res_y``, a frame
  smaller than its window (the host route); the port's vectorized host
  route against vip_tpu's per-pixel loop.
- ``cube_distance`` (every distance, modes full/annulus/mask, reference
  by index, frame and median), ``spectral_correlation`` (with companions
  masked and the spectral FWHM fit), ``frame_average_radprofile``,
  ``frame_histo_stats``, ``descriptive_stats``, ``frame_basic_stats``,
  ``cube_basic_stats`` and ``bkg_star_proba``: 1e-10 of max(|ref|, 1).
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch
import vip_tpu.stats as js
from vip_tpu.stats import clip_sigma as jcs
import vip_tpu_torch.stats as ts
from vip_tpu_torch.stats import clip_sigma as tcs

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.nanmax(np.abs(ref)), 1.0))


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(21)
    a = rng.standard_normal((25, 22))
    a[rng.random(a.shape) < 0.04] += 6
    return a


def _with_nans(frame, seed=2):
    rng = np.random.default_rng(seed)
    f = frame.copy()
    bp = rng.random(f.shape) < 0.05
    bp[9:13, 9:12] = True
    bp[0, 0] = True
    f[bp] = np.nan
    return f, bp


def test_sigma_filter_forces_3x3_and_writes_in_place(frame):
    f, bp = _with_nans(frame)
    ref = jcs.sigma_filter(f.copy(), bp.astype(int))
    mine = f.copy()
    out = ts.sigma_filter(mine, bp.astype(int), neighbor_box=7,
                          min_neighbors=1)
    assert out is mine
    np.testing.assert_array_equal(mine, ref)
    t = ts.sigma_filter(torch.from_numpy(f), bp)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), ref)


def test_sigma_filter_tiny_frame_host_route():
    rng = np.random.default_rng(4)
    f = rng.standard_normal((2, 9))
    bp = np.zeros(f.shape, int)
    bp[0, 3] = bp[1, 8] = 1
    ref = jcs.sigma_filter(f.copy(), bp)
    out = ts.sigma_filter(f.copy(), bp)
    np.testing.assert_array_equal(out, ref)


def test_cube_sigma_filter(frame):
    pairs = [_with_nans(frame, s) for s in range(3)]
    cube = np.stack([p[0] for p in pairs])
    bps = np.stack([p[1] for p in pairs])
    ref = jcs.cube_sigma_filter(cube, bps)
    np.testing.assert_array_equal(tcs.cube_sigma_filter(cube, bps).numpy(),
                                  ref)


@pytest.mark.parametrize("kw", [
    dict(), dict(min_std=2.0), dict(out_good=True),
    dict(neighbor=True), dict(neighbor=True, num_neighbor=5),
    dict(neighbor=True, num_neighbor=4, mad=True),
    dict(neighbor=True, num_neighbor=5, mad=True, min_std=0.5),
    dict(neighbor=True, num_neighbor=5, half_res_y=True),
    dict(neighbor=True, bpm=True), dict(neighbor=True, out_good=True)],
    ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()) or "global")
def test_clip_array(frame, kw):
    kw = dict(kw)
    if kw.pop("bpm", False):
        kw["bpm_mask_ori"] = np.random.default_rng(1).random(
            frame.shape) < 0.1
    ref = jcs.clip_array(frame, 2.5, 2.0, **kw)
    out = ts.clip_array(frame, 2.5, 2.0, **kw)
    assert len(out) == 2
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("shape", ((3, 12), (12, 2), (4, 4)))
def test_clip_array_frame_smaller_than_window(shape):
    rng = np.random.default_rng(9)
    a = rng.standard_normal(shape)
    a.flat[3] += 5
    for mad in (False, True):
        ref = jcs.clip_array(a, 1.5, 1.5, neighbor=True, num_neighbor=5,
                             mad=mad)
        out = ts.clip_array(a, 1.5, 1.5, neighbor=True, num_neighbor=5,
                            mad=mad)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("mad", (False, True))
def test_host_route_against_the_per_pixel_loop(frame, mad):
    gpm = np.random.default_rng(6).random(frame.shape) > 0.08
    # repeated values: the loop removes one copy of the pixel's own
    a = np.round(frame, 1)
    ref = jcs._clip_neighbor_host(a, gpm, 2.0, 2.0, 2, 1, mad, None)
    out = tcs._clip_neighbor_host(a, gpm, 2.0, 2.0, 2, 1, mad, None)
    np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module")
def cube():
    rng = np.random.default_rng(8)
    base = rng.standard_normal((21, 21))
    c = base + 0.3 * rng.standard_normal((6, 21, 21))
    c[2] = np.round(c[2], 1)          # ties for the Spearman ranks
    return c


# vip_tpu's 'ssim' indexes a 2-d map, so it raises on the 1-d vectors of
# the 'annulus' and 'mask' modes; the port computes their 1-d SSIM
# (test_ssim_of_vectors)
DISTANCES = [(d, m) for d in ("sad", "euclidean", "mse", "pearson",
                              "spearman", "ssim")
             for m in ("full", "annulus", "mask")
             if d != "ssim" or m == "full"]


@pytest.mark.parametrize("dist,mode", DISTANCES)
@pytest.mark.parametrize("ref", ("index", "frame", "median"))
def test_cube_distance(cube, dist, mode, ref):
    frame = {"index": 2, "frame": cube[4] + 0.1, "median": None}[ref]
    mask = np.zeros(cube.shape[1:], bool)
    mask[3:15, 5:18] = True
    kw = dict(mode=mode, dist=dist, inradius=3, width=5, mask=mask,
              plot=False)
    _close(ts.cube_distance(cube, frame, **kw),
           js.cube_distance(cube, frame, **kw))


def test_ssim_of_vectors(cube):
    """'ssim' of the 'mask' mode's vectors: skimage's formula on 1-d
    windows (scipy's Gaussian filter, 7 samples a window)."""
    from scipy.ndimage import gaussian_filter

    mask = np.zeros(cube.shape[1:], bool)
    mask[3:15, 5:18] = True
    ref_v = cube[2][mask]

    def ssim(a, b, rng):
        f = lambda x: gaussian_filter(x, 1.5, truncate=3.5)
        ux, uy = f(a), f(b)
        vx = 7 / 6 * (f(a * a) - ux * ux)
        vy = 7 / 6 * (f(b * b) - uy * uy)
        vxy = 7 / 6 * (f(a * b) - ux * uy)
        C1, C2 = (0.01 * rng) ** 2, (0.03 * rng) ** 2
        S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
            (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
        return S[3:-3].mean()

    ref = [ssim(ref_v, fr[mask], ref_v.max() - ref_v.min()) for fr in cube]
    _close(ts.cube_distance(cube, 2, mode="mask", dist="ssim", mask=mask,
                            plot=False), ref)


@pytest.mark.parametrize("full_output", (False, True))
def test_spectral_correlation(full_output):
    rng = np.random.default_rng(12)
    spec = np.linspace(1, 2, 7)[:, None, None]
    cube = spec * rng.standard_normal((1, 31, 31)) \
        + 0.3 * rng.standard_normal((7, 31, 31))
    kw = dict(ann_width=3, r_in=2, pl_xy=[(20, 16)], mask_r=1, fwhm=3,
              full_output=full_output)
    ref = js.spectral_correlation(cube, **kw)
    out = ts.spectral_correlation(cube, **kw)
    if full_output:
        _close(out[0], ref[0])
        np.testing.assert_allclose(out[1].numpy(), ref[1], rtol=1e-6,
                                   atol=1e-6)
    else:
        _close(out, ref)


@pytest.mark.parametrize("init_rad", (None, 4))
def test_frame_average_radprofile(frame, init_rad):
    f = frame[:, :22][:22]
    ref = js.frame_average_radprofile(f, sep=2, init_rad=init_rad,
                                      subtr_profile=True, plot=False)
    out = ts.frame_average_radprofile(f, sep=2, init_rad=init_rad,
                                      subtr_profile=True, plot=False)
    for col in ("rad", "radprof", "npx"):
        _close(out[0][col].to_numpy(), ref[0][col].to_numpy())
    _close(out[1], ref[1])


def test_frame_histo_and_descriptive_stats(frame):
    _close(ts.frame_histo_stats(frame, plot=False),
           js.frame_histo_stats(frame, plot=False))
    for mean in (False, True):
        _close(ts.descriptive_stats(frame, verbose=False, mean=mean),
               js.descriptive_stats(frame, verbose=False, mean=mean))
    sizes = [12, 15, 9, 20]
    _close(ts.descriptive_stats(sizes, verbose=False),
           js.descriptive_stats(sizes, verbose=False))


@pytest.mark.parametrize("region", ("circle", "annulus"))
def test_basic_stats(cube, region):
    kw = dict(region=region, radius=4, xy=(12, 9), inner_radius=3, size=4,
              plot=False, full_output=True)
    _close(ts.frame_basic_stats(cube[1], **kw),
           js.frame_basic_stats(cube[1], **kw))
    _close(np.stack([t.numpy() for t in ts.cube_basic_stats(cube, **kw)]),
           np.stack(js.cube_basic_stats(cube, **kw)))
    kw["full_output"] = False
    _close(ts.cube_basic_stats(cube, **kw), js.cube_basic_stats(cube, **kw))


@pytest.mark.parametrize("sep,n_bkg,unit", ((2.0, 1, "deg"),
                                            (1.5, 3, "arcsec")))
def test_bkg_star_proba(sep, n_bkg, unit):
    ref = js.bkg_star_proba(2e4, sep, n_bkg, unit, verbose=False,
                            full_output=True)
    out = ts.bkg_star_proba(2e4, sep, n_bkg, unit, verbose=False,
                            full_output=True)
    _close(out[0], ref[0])
    _close(out[1], ref[1])

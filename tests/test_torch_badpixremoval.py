"""The port's bad-pixel correction (``preproc.badpixremoval``) and its
device median filter against vip_tpu and scipy, on the CPU at float64.

- ``median_filter_device``: bit-equal to ``scipy.ndimage.median_filter``
  in the modes 'mirror', 'reflect' and 'nearest', odd and even sizes
  (scipy's origin and upper middle), frames smaller than the window,
  windows with NaN (scipy's quickselect);
  ``median_filter_at`` equal to the whole filter at the pixels it takes;
  the batched neighbour clip bit-equal to its per-frame call.
- ``frame_fix_badpix_isolated`` / ``cube_fix_badpix_isolated`` (shared
  map and ``frame_by_frame``, MAD, protected zone, exclusion and given
  maps, ``correct_only``; the 5x5 window holds 24 neighbours, an even
  good count), ``cube_fix_badpix_clump`` (3-d, 2-d, ``half_res_y``,
  ``min_thr``, ``correct_only``), ``cube_fix_badpix_annuli`` (3-d, 2-d,
  ``half_res_y``, the noise floor from an annulus or the whole frame,
  ``min_thr_np``, ``bad_values``, per-frame FWHM; numpy's global
  generator seeded alike): maps equal, frames within 1e-8 of
  max(|ref|, 1). The segmented (frame, annulus) statistics against
  vip_tpu's ``_trimmed_med_std`` on every kind of segment, the batched
  noise floor against ``_sigma_clipped_std``, and the numba quirk of
  ``reject_outliers``.
- ``frame_fix_badpix_fft`` / ``cube_fix_badpix_interp`` 'fft' (an int and
  a list ``nit``, the end at ``Eg < tol``, a self-conjugate frequency,
  each frame's iteration count), 'gauss' and 'psf', ``get_err_spec``.
- ``cube_fix_badpix_ifs`` (clumps and isolated): the batched pair zooms
  against the per-pair ``frame_rescaling`` loop, the 39 → 38 even-count
  residual median with one NaN (numpy's ``median``), and the whole
  correction against vip_tpu.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import scipy.ndimage
import torch

import vip_tpu_torch
from vip_tpu.preproc import badpixremoval as jbp
from vip_tpu_torch.ops import badpix as tops
from vip_tpu_torch.preproc import badpixremoval as tbp

FRAME_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=FRAME_TOL):
    ref = np.asarray(ref, dtype=float)
    got = _np(got).astype(float)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.nanmax(np.abs(ref)), 1.0))


def _same_map(got, ref):
    np.testing.assert_array_equal(_np(got).astype(bool),
                                  np.asarray(ref).astype(bool))


@pytest.fixture(scope="module")
def cube():
    """4 frames of 32² (noise around 10) with 1% hot pixels, a 3x3 hot
    clump and a 4x4 cold one."""
    rng = np.random.default_rng(7)
    c = rng.standard_normal((4, 32, 32)) * 2 + 10
    c[rng.random(c.shape) < 0.01] += 50
    c[1, 10:13, 12:15] += 80
    c[2, 5:9, 20:24] -= 60
    return c


# ---------------------------------------------------------------------------
# the device median filter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("mode", ["mirror", "reflect", "nearest"])
@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 6, 12])
@pytest.mark.parametrize("shape", [(2, 11, 9), (1, 3, 4), (1, 1, 5)])
def test_median_filter_is_scipys(mode, size, shape, nan):
    rng = np.random.default_rng(size)
    x = rng.standard_normal(shape)
    if nan:
        # scipy's selection meets NaN with false comparisons; the windows
        # holding one take the same steps on the device
        x[rng.random(shape) < 0.25] = np.nan
        x[0, :2, :2] = np.nan
    ref = scipy.ndimage.median_filter(x, (1, size, size), mode=mode)
    got = tops.median_filter_device(torch.from_numpy(x), size, mode=mode)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        tbp.median_filter(x[0], size, mode=mode).numpy(),
        scipy.ndimage.median_filter(x[0], size, mode=mode))
    b, y, xx = (torch.as_tensor(v) for v in np.nonzero(np.ones(shape)))
    np.testing.assert_array_equal(
        tops.median_filter_at(torch.from_numpy(x), b, y, xx, size,
                              mode).numpy(), ref.ravel())


def test_cube_median_filter(cube):
    np.testing.assert_array_equal(tbp._cube_median_filter(cube, 5).numpy(),
                                  jbp._cube_median_filter(cube, 5))


@pytest.mark.parametrize("mad", [False, True])
def test_clip_neighbor_batched_is_per_frame(cube, mad):
    bp = np.zeros(cube.shape, bool)
    bp[:, 3, 4] = True
    t = torch.from_numpy(cube)
    batch = tops.clip_neighbor_device(t, ~torch.from_numpy(bp), 3.0, 3.0,
                                      2, 2, mad=mad)
    for i in range(cube.shape[0]):
        one = tops.clip_neighbor_device(t[i], ~torch.from_numpy(bp[i]), 3.0,
                                        3.0, 2, 2, mad=mad)
        assert torch.equal(batch[i], one)
    shared = tops.clip_neighbor_device(t, ~torch.from_numpy(bp[0]), 3.0, 3.0,
                                       1, 2, mad=mad)
    assert torch.equal(shared[2], tops.clip_neighbor_device(
        t[2], ~torch.from_numpy(bp[0]), 3.0, 3.0, 1, 2, mad=mad))


# ---------------------------------------------------------------------------
# isolated, clump and annulus corrections
# ---------------------------------------------------------------------------
ISOLATED = {
    "shared": dict(),
    "shared_mad_protect": dict(mad=True, protect_mask=4),
    "frame_by_frame": dict(frame_by_frame=True),
    "frame_by_frame_mad": dict(frame_by_frame=True, mad=True,
                               protect_mask=5, num_neig=3, size=3),
    "excl": dict(frame_by_frame=True, excl="3d"),
    "shared_excl": dict(excl="2d", sigma_clip=2.5),
    "given_map": dict(bpm="2d"),
    "correct_only": dict(bpm="2d", correct_only=True),
    "correct_only_fbf": dict(bpm="3d", correct_only=True,
                             frame_by_frame=True),
    "global_clip": dict(num_neig=0, frame_by_frame=True),
}


def _masks(cube, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "2d":
        return rng.random(cube.shape[-2:]) < 0.02
    return rng.random(cube.shape) < 0.02


@pytest.mark.parametrize("case", ISOLATED, ids=list(ISOLATED))
def test_cube_fix_badpix_isolated(cube, case):
    kw = dict(ISOLATED[case])
    if "excl" in kw:
        kw["excl_mask"] = _masks(cube, kw.pop("excl"), 1)
    if "bpm" in kw:
        kw["bpm_mask"] = _masks(cube, kw.pop("bpm"), 2)
    theirs = jbp.cube_fix_badpix_isolated(cube, full_output=True,
                                          verbose=False, **kw)
    ours = tbp.cube_fix_badpix_isolated(cube, full_output=True,
                                        verbose=False, **kw)
    assert isinstance(ours[0], torch.Tensor)
    _same_map(ours[1], theirs[1])
    _close(ours[0], theirs[0])


@pytest.mark.parametrize("kw", [dict(), dict(mad=True, protect_mask=3,
                                             cxy=(15, 17)),
                                dict(bpm=True, correct_only=True)])
def test_frame_fix_badpix_isolated(cube, kw):
    kw = dict(kw)
    if kw.pop("bpm", False):
        kw["bpm_mask"] = _masks(cube, "2d", 3)
    theirs = jbp.frame_fix_badpix_isolated(cube[1], full_output=True,
                                           verbose=False, **kw)
    ours = tbp.frame_fix_badpix_isolated(cube[1], full_output=True,
                                         verbose=False, **kw)
    _same_map(ours[1], theirs[1])
    _close(ours[0], theirs[0])


CLUMP = {
    "plain": dict(),
    "half_res_y": dict(half_res_y=True),
    "min_thr_protect": dict(min_thr=5, protect_mask=3, cy=16, cx=16,
                            mad=False),
    "fwhm_per_frame": dict(fwhm=[3, 4, 6, 4], max_nit=3),
    "seeded": dict(bpm=True, sig=5.0),
    "correct_only": dict(bpm=True, correct_only=True),
    "bad_values": dict(bad_values=[0.0]),
}


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("case", CLUMP, ids=list(CLUMP))
def test_cube_fix_badpix_clump(cube, case, two_d):
    kw = dict(CLUMP[case])
    arr = cube.copy()
    if case == "bad_values":
        arr[0, 4, 4] = arr[2, 20, 3] = 0.0
    if two_d:
        arr = arr[1]
        if isinstance(kw.get("fwhm"), list):
            kw["fwhm"] = 5
        if case == "half_res_y":
            # vip_tpu needs the center here (ROADMAP Queue 3); the port
            # takes the frame's
            no_center = tbp.cube_fix_badpix_clump(arr, full_output=True,
                                                  verbose=False, **kw)
            kw.update(cy=16, cx=16)
    if kw.pop("bpm", False):
        kw["bpm_mask"] = _masks(arr, "2d", 4)
    theirs = jbp.cube_fix_badpix_clump(arr, full_output=True, verbose=False,
                                       **kw)
    ours = tbp.cube_fix_badpix_clump(arr, full_output=True, verbose=False,
                                     **kw)
    _same_map(ours[1], theirs[1])
    _close(ours[0], theirs[0])
    if two_d and case == "half_res_y":
        assert torch.equal(no_center[0], ours[0])


ANNULI = {
    "plain": dict(),
    "sig2_protect": dict(sig=2.0, protect_mask=4),
    "half_res_y": dict(half_res_y=True, sig=2.5),
    "whole_frame_floor": dict(r_in_std=0, sig=2.5),
    "r_out": dict(r_in_std=1, r_out_std=3, sig=2.5),
    "min_thr_np": dict(min_thr_np=5.0, protect_mask=3, sig=3.0),
    "seeds_values": dict(bpm=True, bad_values=[0.0], sig=3.0),
    "seeds": dict(bpm=True, sig=3.0),
    "excl": dict(excl=True, sig=2.5),
    "fwhm_per_frame": dict(fwhm=[2, 3, 5, 3], sig=2.5),
    "thresholds": dict(min_thr=4.0, max_thr=40.0, sig=4.0),
}


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("case", ANNULI, ids=list(ANNULI))
def test_cube_fix_badpix_annuli(cube, case, two_d):
    kw = dict(dict(fwhm=3), **ANNULI[case])
    arr = cube.copy()
    if "bad_values" in kw:
        arr[0, 4, 4] = arr[1, 20, 3] = 0.0
    if two_d:
        arr = arr[2]
        if isinstance(kw["fwhm"], list):
            kw["fwhm"] = 4
    if kw.pop("bpm", False):
        # vip_tpu seeds the bad values of a cube into a 3-d map only
        # (ROADMAP Queue 3)
        kw["bpm_mask"] = _masks(arr, "2d" if two_d or "bad_values" not in kw
                                else "3d", 5)
    if kw.pop("excl", False):
        kw["excl_mask"] = _masks(arr, "2d", 6)
    np.random.seed(3)
    theirs = jbp.cube_fix_badpix_annuli(arr, full_output=True,
                                        verbose=False, **kw)
    np.random.seed(3)
    ours = tbp.cube_fix_badpix_annuli(arr, full_output=True, verbose=False,
                                      **kw)
    _same_map(ours[1], theirs[1])
    np.testing.assert_array_equal(_np(ours[2]), np.asarray(theirs[2]))
    _close(ours[0], theirs[0])


def test_annuli_bad_values_with_a_2d_map(cube):
    """A 2-d map and ``bad_values`` on a cube: vip_tpu fails to broadcast
    the map (ROADMAP Queue 3); the port seeds the map of every frame."""
    arr = cube.copy()
    arr[0, 4, 4] = arr[1, 20, 3] = 0.0
    bpm = _masks(arr, "2d", 5)
    with pytest.raises(ValueError):
        jbp.cube_fix_badpix_annuli(arr, 3, bpm_mask=bpm, bad_values=[0.0])
    np.random.seed(3)
    two = tbp.cube_fix_badpix_annuli(arr, 3, bpm_mask=bpm, bad_values=[0.0],
                                     full_output=True, verbose=False)
    np.random.seed(3)
    three = tbp.cube_fix_badpix_annuli(
        arr, 3, bpm_mask=np.repeat(bpm[None], 4, 0) | (arr == 0),
        full_output=True, verbose=False)
    for a, b in zip(two, three):
        assert torch.equal(a, b)


def test_annuli_batched_is_the_frame_loop(cube):
    """The batched frames against the 2-d call frame by frame, the host
    draws made in the same order."""
    np.random.seed(9)
    batch = tbp.cube_fix_badpix_annuli(cube, 3, sig=2.5, full_output=True,
                                       verbose=False)
    np.random.seed(9)
    for i in range(cube.shape[0]):
        one = tbp.cube_fix_badpix_annuli(cube[i], 3, sig=2.5,
                                         min_thr=cube.min() - 1,
                                         max_thr=cube.max() - 1,
                                         full_output=True, verbose=False)
        for k in range(3):
            assert torch.equal(batch[k][i], one[k])


def _segments(rng):
    """Segments of every kind: one value, equal values (MAD 0), a low and
    a high outlier, all negative (the numba quirk), plain noise."""
    return [np.array([3.0]), np.full(6, 2.0), np.r_[rng.normal(0, 1, 30),
                                                    -40.0],
            np.r_[rng.normal(0, 1, 17), 55.0], rng.normal(-20, 0.5, 12),
            rng.normal(5, 2, 40), np.array([1.0, 9.0]), np.array([]),
            np.r_[np.full(5, 1.0), 7.0]]


@pytest.mark.parametrize("stddev", [0.5, 3.0, 100.0])
def test_segment_trimmed_stats(stddev):
    rng = np.random.default_rng(12)
    segs = _segments(rng)
    vals = torch.as_tensor(np.concatenate(segs))
    keys = torch.as_tensor(np.concatenate([np.full(len(s), k)
                                           for k, s in enumerate(segs)]),
                           dtype=torch.int64)
    perm = torch.as_tensor(rng.permutation(vals.numel()))
    med, std = tbp._segment_trimmed_stats(
        vals[perm], keys[perm], len(segs),
        torch.full((len(segs),), stddev, dtype=torch.float64))
    for k, s in enumerate(segs):
        ref = jbp._trimmed_med_std(s, stddev)
        np.testing.assert_allclose([float(med[k]), float(std[k])], ref,
                                   rtol=1e-12, atol=1e-12)


def test_clipped_std_batch_is_the_host_clip():
    """Each row's 2.5-sigma clipped standard deviation about its median,
    rows stopping after different passes, NaN padding dropped, against
    vip_tpu's host helper."""
    rng = np.random.default_rng(8)
    rows = [rng.normal(0, 1, 400), np.r_[rng.normal(0, 1, 300),
                                         rng.normal(9, 0.1, 30)],
            np.r_[rng.normal(5, 2, 200), [np.nan] * 5], np.full(50, 3.0)]
    width = max(len(r) for r in rows)
    pad = np.full((len(rows), width), np.nan)
    for k, r in enumerate(rows):
        pad[k, :len(r)] = r
    got = tbp._clipped_std_batch(torch.from_numpy(pad), sigma=2.5).numpy()
    ref = [jbp._sigma_clipped_std(r, sigma=2.5) for r in rows]
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_reject_outliers_numba_quirk():
    """All-negative data: vip_tpu (the numba variant) compares max(data),
    not max(|d|), with the floor."""
    data = np.array([-30.0, -31.0, -29.5, -30.2, -80.0])
    for test in (-80.0, -30.0, 0.0):
        assert tbp.reject_outliers(data, test, m=5, stddev=1.0) == \
            jbp.reject_outliers(data, test, m=5, stddev=1.0)
    assert tbp.reject_outliers(data, -80.0, stddev=1.0) == 1


def test_find_outliers_and_correct_ann_outliers(cube):
    frame = cube[1]
    seed = np.zeros(frame.shape)
    seed[10, 12] = 1
    np.testing.assert_array_equal(
        tbp.find_outliers(frame, 4.0, in_bpix=seed, stddev=2.0),
        jbp.find_outliers(frame, 4.0, in_bpix=seed, stddev=2.0))
    nrad = 20
    med = np.linspace(10, 12, nrad)
    std = np.linspace(1, 3, nrad)
    rand = np.random.default_rng(1).uniform(-1, 1, frame.shape)
    theirs = jbp.correct_ann_outliers(frame, seed, 1.5, 3.0, med, std, 16,
                                      16, 0.0, 60.0, 1.5, rand_arr=rand)
    ours = tbp.correct_ann_outliers(frame, seed, 1.5, 3.0, med, std, 16, 16,
                                    0.0, 60.0, 1.5, rand_arr=rand)
    _same_map(ours[1], theirs[1])
    _close(ours[0], theirs[0])


# ---------------------------------------------------------------------------
# interpolation: gauss/psf convolution and the [AAC01] FFT fill
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def holes(cube):
    bpm = np.zeros(cube.shape, bool)
    rng = np.random.default_rng(2)
    bpm[rng.random(cube.shape) < 0.01] = True
    bpm[1, 10:13, 12:15] = True
    return bpm


def _captured_iterations(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, [int(n) for n in re.findall(r"after (\d+) iterations",
                                            buf.getvalue())]


@pytest.mark.parametrize("nit,tol,offset", [
    (60, 1e-3, 0.0),          # runs its nit
    (400, 200.0, 0.0),        # stops at Eg < tol
    (30, 1e-3, 1000.0),       # the first component at (0, 0): self-conjugate
    ([5, 20, 40], 1e-3, 0.0),
    ([3, 50, 400], 200.0, 0.0)])
def test_frame_fix_badpix_fft(cube, holes, nit, tol, offset):
    frame = cube[1] + offset
    theirs, its_j = _captured_iterations(lambda: jbp.frame_fix_badpix_fft(
        frame, holes[1], nit=nit, tol=tol, full_output=True, verbose=True))
    ours = tbp.frame_fix_badpix_fft(frame, holes[1], nit=nit, tol=tol,
                                    full_output=True, verbose=False)
    _, _, its = tbp._fft_fill_frames(torch.from_numpy(frame[None]),
                                     torch.from_numpy(holes[1][None]), nit,
                                     tol, 2, False)
    assert list(its) == its_j
    for k in (0, 1):
        if isinstance(nit, list):
            assert len(ours[k]) == len(theirs[k])
            for a, b in zip(ours[k], theirs[k]):
                _close(a, b)
        else:
            _close(ours[k], theirs[k])


def test_fft_fill_batched_is_the_frame_loop(cube, holes):
    """All frames at once, each frozen at its own end, against each frame
    alone; the iteration counts differ between frames."""
    frames = torch.from_numpy(cube)
    masks = torch.from_numpy(holes)
    res, spe, its = tbp._fft_fill_frames(frames, masks, 400, 1e4, 2, True)
    assert len(set(its.tolist())) == 4
    for i in range(4):
        r1, s1, i1 = tbp._fft_fill_frames(frames[i:i + 1], masks[i:i + 1],
                                          400, 1e4, 2, True)
        assert i1[0] == its[i]
        _close(res[i], r1[0])
        _close(spe[i], s1[0])


def test_cube_fix_badpix_interp_fft(cube, holes):
    theirs = jbp.cube_fix_badpix_interp(cube, holes, mode="fft", nit=50,
                                        tol=1e-3, full_output=True)
    ours = tbp.cube_fix_badpix_interp(cube, holes, mode="fft", nit=50,
                                      tol=1e-3, full_output=True)
    _close(ours[0], theirs[0])
    _close(ours[1], theirs[1])


@pytest.mark.parametrize("kw", [dict(mode="gauss", fwhm=3),
                                dict(mode="gauss", fwhm=[2, 3, 4, 3]),
                                dict(mode="gauss", fwhm=3, half_res_y=True),
                                dict(mode="psf"), dict(mode="gauss", fwhm=2,
                                                       excl=True)])
def test_cube_fix_badpix_interp_conv(cube, holes, kw):
    kw = dict(kw)
    if kw["mode"] == "psf":
        yy, xx = np.mgrid[:7, :7]
        kw["psf"] = np.exp(-((yy - 3) ** 2 + (xx - 3) ** 2) / 3.0)
    if kw.pop("excl", False):
        kw["excl_mask"] = _masks(cube, "2d", 7)
    theirs = jbp.cube_fix_badpix_interp(cube, holes, **kw)
    ours = tbp.cube_fix_badpix_interp(cube, holes, **kw)
    _close(ours, theirs)
    two = dict(kw, fwhm=3) if isinstance(kw.get("fwhm"), list) else kw
    _close(tbp.cube_fix_badpix_interp(cube[1], holes[1], **two),
           jbp.cube_fix_badpix_interp(cube[1], holes[1], **two))


def test_get_err_spec():
    rng = np.random.default_rng(5)
    W = rng.standard_normal((8, 10)) + 1j * rng.standard_normal((8, 10))
    G = rng.standard_normal((8, 10)) + 1j * rng.standard_normal((8, 10))
    for ind in ((0, 0), (4, 0), (3, 2), (0, 5)):
        np.testing.assert_allclose(
            tbp.get_err_spec(1.5 - 0.5j, W, ind, 80, G, (8, 10)).numpy(),
            jbp.get_err_spec(1.5 - 0.5j, W, ind, 80, G, (8, 10)),
            rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# IFS: SDI residuals
# ---------------------------------------------------------------------------
def _ifs_cube(z, s, seed):
    rng = np.random.default_rng(seed)
    lbda = np.linspace(1.0, 1.3, z)
    yy, xx = np.mgrid[:s, :s]
    c = s // 2
    cube = np.stack([200 * np.exp(-((yy - c) ** 2 + (xx - c) ** 2)
                                  / (2 * (1.5 * lb) ** 2)) for lb in lbda])
    cube += rng.standard_normal(cube.shape)
    cube[2, 5, 6] += 100
    cube[z - 1, s - 8:s - 6, 4:6] += 150
    return cube, lbda


def test_sdi_pair_zooms_are_frame_rescaling():
    cube, lbda = _ifs_cube(5, 20, 1)
    ch = torch.from_numpy(cube)
    scal = lbda[-1] / lbda
    flux = np.linspace(0.9, 1.1, 5)
    _close(tbp._sdi_diffs_batched(ch, scal, flux),
           tbp._sdi_diffs_plain(ch, scal, flux, None, "vip-fft", "lanczos4"))


def test_residual_median_is_numpys_median():
    """The 38 residuals of each of 39 channels, one of them NaN at a
    pixel: numpy's median (any NaN gives NaN; an even count averages the
    two middles), as one median over axis 0 of the (38, 39·y, x) stack."""
    rng = np.random.default_rng(6)
    diffs = rng.standard_normal((39, 38, 6, 5))
    diffs[7, 11, 2, 3] = np.nan
    stack = torch.from_numpy(diffs).permute(1, 0, 2, 3).reshape(38, 39 * 6, 5)
    got = tbp._median_axis0(stack, True).reshape(39, 6, 5).numpy()
    ref = np.median(diffs, axis=1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[7, 2, 3]) and np.isnan(got).sum() == 1
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def ifs_case():
    cube, lbda = _ifs_cube(5, 24, 2)
    out = {}
    for clumps in (True, False):
        out[clumps] = jbp.cube_fix_badpix_ifs(cube, lbda, clumps=clumps,
                                              verbose=False,
                                              full_output=True)
    return cube, lbda, out


@pytest.mark.parametrize("clumps", [True, False])
def test_cube_fix_badpix_ifs(ifs_case, clumps):
    cube, lbda, theirs = ifs_case
    ours = tbp.cube_fix_badpix_ifs(cube, lbda, clumps=clumps, verbose=False,
                                   full_output=True)
    _close(ours[2], theirs[clumps][2])
    _same_map(ours[1], theirs[clumps][1])
    _close(ours[0], theirs[clumps][0])
    assert _np(ours[1])[2, 5, 6] == 1

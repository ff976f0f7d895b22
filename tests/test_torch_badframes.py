"""The port's bad-frame detection (``preproc.badframes``) against
vip_tpu, on the CPU at float64: the index lists equal.

- ``cube_detect_badfr_pxstats`` ('annulus' and 'circle', 'mean' and
  'median', the default and an even rolling window); its centered rolling
  mean against pandas' ``rolling(center=True).mean().bfill().ffill()`` for
  odd and even windows (pandas centers an even window on the upper
  middle), a window longer than the series included.
- ``cube_detect_badfr_ellipticity``: the roundness of every frame from one
  batched convolution; ``_daofind_roundness`` of one frame.
- ``cube_detect_badfr_correlation``: 'pearson', 'spearman', 'sad', 'mse',
  a reference frame given as an index or a frame, an explicit threshold,
  the 'annulus' mode; the distances within 1e-10 of max(|ref|, 1).
"""

import numpy as np
import pytest

import vip_tpu_torch
from vip_tpu.preproc import badframes as jbf
from vip_tpu_torch.preproc import badframes as tbf


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(scope="module")
def cube():
    """30 frames of 40² with a Gaussian star: frames 3, 11 and 17
    elongated, 5 and 22 dimmed, 9 and 26 shifted by 2 px."""
    rng = np.random.default_rng(4)
    n, s, c = 30, 40, 20
    yy, xx = np.mgrid[:s, :s]
    out = np.empty((n, s, s))
    for i in range(n):
        sx = 3.0 if i in (3, 11, 17) else 1.5
        amp = 30 if i in (5, 22) else 100
        dy = 2 if i in (9, 26) else 0
        out[i] = amp * np.exp(-((yy - c - dy) ** 2 / (2 * 1.5 ** 2)
                                + (xx - c) ** 2 / (2 * sx ** 2))) \
            + rng.standard_normal((s, s))
    return out


def _equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window", [None, 4, 7])
@pytest.mark.parametrize("mode,method", [("annulus", "mean"),
                                         ("annulus", "median"),
                                         ("circle", "mean"),
                                         ("circle", "median")])
def test_cube_detect_badfr_pxstats(cube, mode, method, window):
    kw = dict(mode=mode, in_radius=2 if mode == "annulus" else 4, width=4,
              method=method, window=window, plot=False, verbose=False)
    theirs = jbf.cube_detect_badfr_pxstats(cube, **kw)
    _equal(tbf.cube_detect_badfr_pxstats(cube, **kw), theirs)
    assert len(theirs[1])


@pytest.mark.parametrize("window", [1, 2, 3, 4, 7, 8, 25, 26])
def test_rolling_mean_is_pandas(window):
    import pandas as pd
    v = np.random.default_rng(window).standard_normal(25)
    ref = pd.Series(v).rolling(window, center=True).mean().bfill().ffill()
    got = tbf._rolling_mean_centered(v, window)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref.to_numpy()))
    np.testing.assert_allclose(got, ref.to_numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(fwhm=3.5, crop_size=20),
                                dict(fwhm=4, crop_size=25, roundlo=-0.1,
                                     roundhi=0.1)])
def test_cube_detect_badfr_ellipticity(cube, kw):
    theirs = jbf.cube_detect_badfr_ellipticity(cube, plot=False,
                                               verbose=False, **kw)
    _equal(tbf.cube_detect_badfr_ellipticity(cube, plot=False,
                                             verbose=False, **kw), theirs)
    assert {3, 11, 17} <= set(theirs[1].tolist())


def test_daofind_roundness(cube):
    for i in (0, 3):
        np.testing.assert_allclose(
            tbf._daofind_roundness(cube[i, 10:30, 10:30], 3.5),
            jbf._daofind_roundness(cube[i, 10:30, 10:30], 3.5),
            rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(frame_ref=0, dist="pearson"), dict(frame_ref=0, dist="spearman"),
    dict(frame_ref=0, dist="sad"), dict(frame_ref=1, dist="mse"),
    dict(frame_ref="frame", dist="pearson", percentile=10),
    dict(frame_ref=0, dist="euclidean", threshold=150.0),
    dict(frame_ref=0, dist="pearson", mode="annulus", inradius=2,
         width=5)])
def test_cube_detect_badfr_correlation(cube, kw):
    kw = dict(kw)
    if kw["frame_ref"] == "frame":
        kw["frame_ref"] = cube[7]
    ref = kw.pop("frame_ref")
    theirs = jbf.cube_detect_badfr_correlation(cube, ref, crop_size=20,
                                               plot=False, verbose=False,
                                               full_output=True, **kw)
    ours = tbf.cube_detect_badfr_correlation(cube, ref, crop_size=20,
                                             plot=False, verbose=False,
                                             full_output=True, **kw)
    _equal(ours[:2], theirs[:2])
    np.testing.assert_allclose(ours[2], theirs[2], rtol=0, atol=1e-10 * max(
        np.abs(theirs[2]).max(), 1.0))

"""Bad-frame detection in cubes (port of ``vip_tpu.preproc.badframes``).

Each statistic is one batched pass over the cube on its device: the
per-frame annulus means (``stats.cube_basic_stats``), the DAOFIND
convolution of every cropped frame (one zero-padded 2-d convolution),
the distances to the reference frame (``stats.cube_distance``). The
per-frame decisions, and the centered rolling mean that vip_tpu takes
from pandas, run on the host over one value a frame. No pandas, and
matplotlib only under ``plot=True``.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..config import time_ini, timing
from ..config.device import as_tensor
from ..config.utils_conf import check_array
from ..stats.clip_sigma import _host
from ..stats.distances import cube_distance
from ..stats.utils_stats import cube_basic_stats
from .cosmetics import cube_crop_frames, frame_crop

__all__ = ["cube_detect_badfr_pxstats", "cube_detect_badfr_ellipticity",
           "cube_detect_badfr_correlation"]


def _rolling_mean_centered(values, window):
    """pandas' ``Series(values).rolling(window, center=True).mean()``
    then ``bfill().ffill()`` (vip_tpu badframes.py:16), without pandas:
    the window of label i spans [i - window // 2, i - window // 2 +
    window - 1] (an even window centers on the upper middle), the labels
    it does not fit take the nearest computed value."""
    v = np.asarray(values, dtype=float)
    n = v.size
    out = np.full(n, np.nan)
    if window < 1:
        raise ValueError("window must be an integer 0 or greater")
    if window <= n:
        cs = np.concatenate([[0.0], np.cumsum(v)])
        means = (cs[window:] - cs[:-window]) / window
        start = window // 2
        out[start:start + means.size] = means
        out[:start] = means[0]
        out[start + means.size:] = means[-1]
    return out


def cube_detect_badfr_pxstats(array, mode="annulus", in_radius=10, width=10,
                              top_sigma=1.0, low_sigma=1.0, window=None,
                              method="mean", plot=True, verbose=True):
    """Bad frames from the pixel statistics of an annulus or a circle
    (vip_tpu badframes.py:26): every frame's statistics in one batched
    gather, against a centered rolling mean ± sigma of the series.
    Returns (good_idx, bad_idx) as numpy."""
    check_array(array, 3, msg="array")
    if mode == "annulus":
        if in_radius + width > array[0].shape[0] / 2:
            raise ValueError("Inner radius and annulus size are too big")
    elif mode == "circle":
        if in_radius > array[0].shape[0] / 2:
            raise ValueError("Radius size is too big (out of boundaries)")
    if verbose:
        start_time = time_ini()
    n = array.shape[0]

    res = cube_basic_stats(array, mode, radius=in_radius,
                           inner_radius=in_radius, size=width,
                           full_output=True)
    mean_values = _host(res[0] if method == "mean" else res[2])
    if window is None:
        window = n // 3
    mean_smooth = _rolling_mean_centered(mean_values, window)
    sigma = np.std(mean_values)
    top_boundary = mean_smooth + top_sigma * sigma
    bot_boundary = mean_smooth - low_sigma * sigma
    # as vip_tpu, the annulus mode tests each frame's annulus mean, with
    # method='median' too
    test = _host(res[0]) if mode == "annulus" else mean_values
    bad = (test > top_boundary) | (test < bot_boundary)
    bad_index_list = np.nonzero(bad)[0]
    good_index_list = np.nonzero(~bad)[0]

    if plot:
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8, 4))
        plt.plot(mean_values, "o", alpha=0.6)
        plt.plot(mean_smooth, label="smoothed mean fluctuation", lw=2,
                 ls="-", alpha=0.5)
        plt.plot(top_boundary, label="upper threshold", lw=1.4, ls="-",
                 color="#9467bd", alpha=0.8)
        plt.plot(bot_boundary, label="lower threshold", lw=1.4, ls="-",
                 color="#9467bd", alpha=0.8)
        plt.legend(fancybox=True, framealpha=0.5, loc="best")
        plt.grid("on", alpha=0.2)
        plt.ylabel("Mean value in " + mode)
        plt.xlabel("Frame number")

    if verbose:
        nbad = len(bad_index_list)
        print("Done detecting bad frames from cube: {} out of {} "
              "({:.3}%)".format(nbad, n, (nbad * 100) / n))
        timing(start_time)
    return good_index_list, bad_index_list


def _daofind_kernel(fwhm):
    """The lowered Gaussian kernel of ``_daofind_roundness`` (vip_tpu
    badframes.py:148-165) and its half size, host float64."""
    sigma = fwhm * 0.42466
    ksize = max(3, int(2 * np.ceil(1.5 * sigma)) + 1)
    half = ksize // 2
    yk, xk = np.mgrid[-half:half + 1, -half:half + 1]
    g = np.exp(-(xk ** 2 + yk ** 2) / (2 * sigma ** 2))
    mask = (xk ** 2 + yk ** 2) <= (1.5 * fwhm) ** 2
    g = g * mask
    kern = (g - g[mask].mean() * mask) / np.sum((g[mask]
                                                 - g[mask].mean()) ** 2)
    return kern, half, sigma


def _daofind_convolve(frames, kern):
    """``scipy.ndimage.convolve(frame, kern, mode="constant")`` of every
    frame of a (B, ny, nx) tensor in one zero-padded 2-d convolution (the
    kernel is symmetric: the correlation of ``conv2d`` is the
    convolution)."""
    half = kern.shape[0] // 2
    w = torch.as_tensor(kern, dtype=frames.dtype, device=frames.device)
    return F.conv2d(frames[:, None], w[None, None], padding=half)[:, 0]


def _roundness_from(frame, conv, half, sigma):
    """(roundness1, roundness2) of a host frame and its convolution
    (vip_tpu badframes.py:166-195)."""
    py, px = np.unravel_index(np.argmax(conv), conv.shape)
    py = int(np.clip(py, half, frame.shape[0] - half - 1))
    px = int(np.clip(px, half, frame.shape[1] - half - 1))
    cut = frame[py - half:py + half + 1, px - half:px + half + 1]
    gx = np.exp(-(np.arange(-half, half + 1)) ** 2 / (2 * sigma ** 2))
    margx = cut.sum(axis=0)
    margy = cut.sum(axis=1)

    def _height(marg):
        w = gx - gx.mean()
        denom = np.sum(w * gx)
        return np.sum(w * marg) / denom if denom != 0 else 0.0

    hx = _height(margx)
    hy = _height(margy)
    roundness1 = 2 * (hx - hy) / (hx + hy) if (hx + hy) != 0 else np.inf
    c = conv[py - half:py + half + 1, px - half:px + half + 1]
    sum2 = c[half, half + 1:].sum() + c[half, :half].sum()
    sum4 = c[half + 1:, half].sum() + c[:half, half].sum()
    denom = sum2 + sum4
    roundness2 = 2.0 * (sum2 - sum4) / denom if denom != 0 else np.inf
    return roundness1, roundness2


def _daofind_roundness(frame, fwhm):
    """Roundness statistics of the brightest star, following the DAOFIND
    definitions of photutils' DAOStarFinder ([STE87]; vip_tpu
    badframes.py:148): GROUND (roundness1) from the marginal Gaussian
    heights, SROUND (roundness2) from the 4-fold symmetry of the convolved
    peak."""
    frame = as_tensor(frame)
    if not frame.is_floating_point():
        frame = frame.to(torch.float64)
    kern, half, sigma = _daofind_kernel(fwhm)
    conv = _daofind_convolve(frame[None], kern)[0]
    return _roundness_from(_host(frame).astype(float), _host(conv), half,
                           sigma)


def cube_detect_badfr_ellipticity(array, fwhm, crop_size=30, roundlo=-0.2,
                                  roundhi=0.2, plot=True, verbose=True):
    """Bad frames from the roundness of the central PSF, DAOFIND-style
    (vip_tpu badframes.py:93): every cropped frame convolved in one
    batched call, the roundness of each on the host. Returns (good_idx,
    bad_idx) as numpy."""
    check_array(array, 3, msg="array")
    if verbose:
        start_time = time_ini()
    cube = cube_crop_frames(as_tensor(array), crop_size, verbose=False)
    if not cube.is_floating_point():
        cube = cube.to(torch.float64)
    n = cube.shape[0]
    kern, half, sigma = _daofind_kernel(fwhm)
    conv = _host(_daofind_convolve(cube, kern))
    frames = _host(cube).astype(float)
    roundness1, roundness2 = np.empty(n), np.empty(n)
    for i in range(n):
        roundness1[i], roundness2[i] = _roundness_from(frames[i], conv[i],
                                                       half, sigma)
    good = (roundhi > roundness1) & (roundness1 > roundlo) \
        & (roundhi > roundness2) & (roundness2 > roundlo)
    good_index_list = np.nonzero(good)[0]
    bad_index_list = np.nonzero(~good)[0]

    if plot:
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(figsize=(8, 4))
        x = np.arange(n)
        marker = "," if n > 5000 else "o"
        for vec, col, lab in ((roundness1, "#1f77b4", "roundness1"),
                              (roundness2, "#9467bd", "roundness2")):
            ax.plot(x, vec, "-", alpha=0.6, color=col, label=lab)
            ax.plot(x, vec, marker=marker, ls="", alpha=0.4, color=col)
        ax.hlines(roundlo, xmin=-1, xmax=n + 1, lw=2, colors="#ff7f0e",
                  linestyles="dashed", label="roundlo", alpha=0.6)
        ax.hlines(roundhi, xmin=-1, xmax=n + 1, lw=2, colors="#ff7f0e",
                  linestyles="dashdot", label="roundhi", alpha=0.6)
        ax.set_xlabel("Frame number")
        ax.set_ylabel("Roundness")
        ax.set_xlim(-1, n + 1)
        ax.legend(fancybox=True, framealpha=0.5, loc="best")
        ax.grid("on", alpha=0.2)

    if verbose:
        nbad = len(bad_index_list)
        print("Done detecting bad frames from cube: {} out of {} "
              "({:.3}%)".format(nbad, n, (nbad * 100) / n))
        timing(start_time)
    return good_index_list, bad_index_list


def cube_detect_badfr_correlation(array, frame_ref, crop_size=30,
                                  dist="pearson", percentile=20,
                                  threshold=None, mode="full", inradius=None,
                                  width=None, plot=True, verbose=True,
                                  full_output=False):
    """Bad frames from the distance of each frame to a reference frame
    (vip_tpu badframes.py:198): the distances in one batched pass
    (``stats.cube_distance``), thresholded at numpy's (linear) percentile.
    Returns (good_idx, bad_idx[, distances]) as numpy."""
    check_array(array, 3, msg="array")
    if verbose:
        start_time = time_ini()
    n = array.shape[0]
    subarray = cube_crop_frames(as_tensor(array), crop_size, verbose=False)
    if isinstance(frame_ref, (np.ndarray, torch.Tensor)):
        frame_ref = frame_crop(frame_ref, crop_size, verbose=False)
    distances = _host(cube_distance(subarray, frame_ref, mode, dist,
                                    inradius=inradius, width=width,
                                    plot=False)).astype(float)

    if dist in ("pearson", "spearman", "ssim"):
        minval = np.min(distances[~np.isnan(distances)])
        distances = np.nan_to_num(distances)
        distances[np.where(distances == 0)] = minval
        if threshold is None:
            threshold = np.percentile(distances, percentile)
        indbad = np.where(distances <= threshold)
        indgood = np.where(distances > threshold)
    else:
        if threshold is None:
            threshold = np.percentile(distances, 100 - percentile)
        indbad = np.where(distances >= threshold)
        indgood = np.where(distances < threshold)
    bad_index_list = indbad[0]
    good_index_list = indgood[0]

    if plot:
        import matplotlib.pyplot as plt

        ylabels = {"sad": "SAD - Manhattan distance",
                   "euclidean": "Euclidean distance",
                   "pearson": "Pearson correlation coefficient",
                   "spearman": "Spearman correlation coefficient",
                   "mse": "Mean squared error",
                   "ssim": "Structural Similarity Index"}
        _, ax = plt.subplots(figsize=(8, 4))
        x = np.arange(n)
        marker = "," if n > 5000 else "o"
        ax.plot(x, distances, "-", alpha=0.6, color="#1f77b4")
        ax.plot(x, distances, marker=marker, ls="", alpha=0.4,
                color="#1f77b4")
        if isinstance(frame_ref, int):
            ax.vlines(frame_ref, ymin=np.nanmin(distances),
                      ymax=np.nanmax(distances), colors="green",
                      linestyles="dashed", lw=2, alpha=0.6,
                      label=f"Reference frame {frame_ref}")
        ax.hlines(threshold, xmin=-1, xmax=n + 1, lw=2, colors="#ff7f0e",
                  linestyles="dashed", label="Threshold", alpha=0.6)
        ax.set_xlabel("Frame number")
        ax.set_ylabel(ylabels.get(dist, dist))
        ax.set_xlim(-1, n + 1)
        ax.legend(fancybox=True, framealpha=0.5, loc="best")
        ax.grid("on", alpha=0.2)

    if verbose:
        nbad = len(bad_index_list)
        print("Done detecting bad frames from cube: {} out of {} "
              "({:.3}%)".format(nbad, n, (nbad * 100) / n))
        timing(start_time)
    if full_output:
        return good_index_list, bad_index_list, distances
    return good_index_list, bad_index_list

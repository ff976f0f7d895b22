"""Descriptive statistics of arrays and of frame regions (port of
``vip_tpu.stats.utils_stats``). The statistics are reductions on the
array's device, a cube's frames in one batched gather; they return host
floats (a frame) or tensors (a cube). matplotlib is imported only for
``plot=True``."""

import numpy as np
import torch

from ..config.device import as_tensor
from ..var.shapes import get_annulus_segments, get_circle
from .clip_sigma import _median_all

__all__ = ["descriptive_stats", "frame_basic_stats", "cube_basic_stats"]


def descriptive_stats(array, verbose=True, label="", mean=False,
                      plot=False):
    """(min, 1st quartile, [mean,] median, 3rd quartile, max) of an array
    or list, numpy's linear percentiles and median (vip_tpu
    utils_stats.py:12), as host floats; ``plot`` draws a box plot."""
    a = as_tensor(array).reshape(-1)
    if not a.is_floating_point():
        a = a.to(torch.float64)
    if mean:
        mean_ = float(a.mean())
    median = float(_median_all(a))
    mini, maxi = float(a.min()), float(a.max())
    first_qu, third_qu = (float(q) for q in torch.quantile(
        a, torch.tensor([0.25, 0.75], dtype=a.dtype, device=a.device)))
    if verbose:
        if mean:
            label += "min={:.1f} / 1st QU={:.1f} / ave={:.1f} / med={:.1f}"
            label += " / 3rd QU={:.1f} / max={:.1f}"
            print(label.format(mini, first_qu, mean_, median, third_qu,
                               maxi))
        else:
            label += "min={:.1f} / 1st QU={:.1f} / med={:.1f} / 3rd "
            label += "QU={:.1f} / max={:.1f}"
            print(label.format(mini, first_qu, median, third_qu, maxi))
    if plot:
        import matplotlib.pyplot as plt

        plt.boxplot(a.cpu().numpy(), vert=False, meanline=mean,
                    showfliers=True, sym=".")
        plt.grid("on", alpha=0.2)
    if mean:
        return mini, first_qu, mean_, median, third_qu, maxi
    return mini, first_qu, median, third_qu, maxi


def _region_index(shape, region, radius, xy, inner_radius, size):
    """Host (yy, xx) of a circle of ``radius`` at ``xy`` (x, y; the center
    by default) or of the centered annulus (``inner_radius``, ``size``)."""
    if region == "circle":
        x, y = xy if xy is not None else (None, None)
        return get_circle(np.zeros(shape), radius, cy=y, cx=x, mode="ind")
    elif region == "annulus":
        return get_annulus_segments(shape, inner_radius, size)[0]
    raise ValueError("Region not recognized")


def _region_stats(vals):
    """(mean, std, median, max) over the last axis of (..., P) values:
    ddof 0, numpy's median."""
    s = torch.sort(vals, dim=-1).values
    P = s.shape[-1]
    median = 0.5 * (s[..., (P - 1) // 2] + s[..., P // 2])
    return (vals.mean(dim=-1), vals.std(dim=-1, correction=0), median,
            s[..., -1])


def _plot_region_histogram(frame, vals, region, radius, xy, inner_radius,
                           size):
    """The frame with the region over it and the region's histogram
    (vip_tpu utils_stats.py:56)."""
    import matplotlib.pyplot as plt

    overlay = np.full(frame.shape, np.nan)
    idx = _region_index(frame.shape, region, radius, xy, inner_radius, size)
    overlay[idx] = frame[idx] if region == "circle" else 1.0
    plt.figure("Image crop (first slice)", figsize=(10, 4))
    ax1 = plt.subplot(1, 2, 1)
    ax1.imshow(frame, origin="lower", interpolation="nearest", cmap="gray")
    ax1.imshow(overlay, origin="lower", interpolation="nearest",
               cmap="viridis")
    ax1.set_title("Frame region")
    ax2 = plt.subplot(1, 2, 2)
    ax2.hist(vals, bins=max(1, int(np.sqrt(np.size(vals)))), alpha=0.5,
             histtype="stepfilled")
    ax2.set_title("Histogram")
    ax2.tick_params(axis="x", labelsize=8)
    plt.show()


def frame_basic_stats(arr, region="circle", radius=5, xy=None,
                      inner_radius=0, size=5, plot=True,
                      full_output=False):
    """Mean of a frame's values in a circle (``radius`` at ``xy``) or an
    annulus (``inner_radius``, ``size``), and with ``full_output`` (mean,
    std, median, max) (vip_tpu utils_stats.py:84), as host floats."""
    fr = as_tensor(arr)
    yy, xx = _region_index(tuple(fr.shape), region, radius, xy,
                           inner_radius, size)
    vals = fr[torch.as_tensor(yy, device=fr.device),
              torch.as_tensor(xx, device=fr.device)]
    mean, std_dev, median, maxi = (float(v) for v in _region_stats(vals))
    if plot:
        _plot_region_histogram(fr.cpu().numpy(), vals.cpu().numpy(), region,
                               radius, xy, inner_radius, size)
    if full_output:
        return mean, std_dev, median, maxi
    return mean


def cube_basic_stats(arr, region="circle", radius=5, xy=None,
                     inner_radius=0, size=5, plot=False, full_output=False):
    """:func:`frame_basic_stats` of every frame of a cube in one gather
    (vip_tpu utils_stats.py:103): tensors of one value a frame, the mean,
    or (mean, std, median, max) with ``full_output``."""
    cube = as_tensor(arr)
    yy, xx = _region_index(tuple(cube.shape[-2:]), region, radius, xy,
                           inner_radius, size)
    vals = cube[:, torch.as_tensor(yy, device=cube.device),
                torch.as_tensor(xx, device=cube.device)]
    mean, std_dev, median, maxi = _region_stats(vals)
    if plot:
        import matplotlib.pyplot as plt

        _plot_region_histogram(cube[0].cpu().numpy(), vals[0].cpu().numpy(),
                               region, radius, xy, inner_radius, size)
        fig = plt.figure("Stats in annulus", figsize=(10, 6))
        fig.subplots_adjust(hspace=0.15)
        series = [(mean, f"Mean value in {region}"),
                  (std_dev, f"Px std dev in {region}"),
                  (maxi, f"Max value in {region}")]
        ax0 = None
        for k, (vec, lab) in enumerate(series):
            ax = plt.subplot(3, 1, k + 1, sharex=ax0)
            ax0 = ax0 or ax
            ax.plot(vec.cpu().numpy(), ".-", label=lab, lw=0.8, alpha=0.6)
            ax.legend(loc=1, fancybox=True).get_frame().set_alpha(0.5)
            ax.grid(True, alpha=0.2)
            if k < 2:
                plt.setp(ax.get_xticklabels(), visible=False)
        ax.set_xlabel("Frame number")
        plt.show()
    if full_output:
        return mean, std_dev, median, maxi
    return mean

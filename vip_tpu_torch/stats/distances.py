"""Distances and similarities between frames, and the spectral
correlation of IFS channels (port of ``vip_tpu.stats.distances``).

``cube_distance`` measures every frame against the reference in one
batched pass on the cube's device: 'sad', 'euclidean', 'mse', 'pearson'
(scipy's normalized dot product), 'spearman' (the Pearson correlation of
ranks, ties given scipy's average rank) and 'ssim' (Wang et al. 2004 as
skimage computes it: separable Gaussian windows of sigma 1.5, scipy's
'reflect' edges and ``truncate=3.5``). matplotlib is imported only for
``plot=True``.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..var.shapes import get_annulus_segments, get_circle

__all__ = ["cube_distance", "spectral_correlation"]

_GAUSSIAN_FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))


def _median0(cube):
    """Per-pixel median over frames, NaN wherever a frame is NaN (as
    ``np.median``): H1 where its gate allows, the plain version
    otherwise."""
    from ..ops.median import nanmedian_axis0, nanmedian_plain
    from ..preproc import subsampling

    if subsampling.nanmedian_supported(cube, 0):
        return nanmedian_axis0(cube.contiguous(), propagate=True)
    return nanmedian_plain(cube, 0, propagate=True)


def _pearson(x, y):
    """Pearson's r of x (P,) against each row of y (n, P), as
    ``scipy.stats.pearsonr``: the dot product of the centered vectors,
    each divided by its norm, clipped to [-1, 1]."""
    xm = x - x.mean()
    ym = y - y.mean(dim=-1, keepdim=True)
    xm = xm / torch.linalg.vector_norm(xm)
    ym = ym / torch.linalg.vector_norm(ym, dim=-1, keepdim=True)
    return (ym @ xm).clamp(-1.0, 1.0)


def _average_ranks(v):
    """Ranks 1..P of each row of v, tied values given the mean of their
    ranks (``scipy.stats.rankdata(method="average")``)."""
    s, order = torch.sort(v, dim=-1)
    P = s.shape[-1]
    pos = torch.arange(P, device=v.device).expand_as(s)
    new = torch.ones_like(s, dtype=torch.bool)
    new[..., 1:] = s[..., 1:] != s[..., :-1]
    last = torch.ones_like(new)
    last[..., :-1] = new[..., 1:]
    start = torch.cummax(torch.where(new, pos, 0), dim=-1).values
    end = torch.where(last, pos, P - 1).flip(-1).cummin(dim=-1).values \
        .flip(-1)
    ranks = torch.empty_like(v)
    ranks.scatter_(-1, order, (start + end).to(v.dtype) / 2 + 1)
    return ranks


def _gauss_filter(x, nd, sigma=1.5, truncate=3.5):
    """``scipy.ndimage.gaussian_filter(x, sigma, truncate=truncate)`` over
    the last ``nd`` axes (mode 'reflect': d c b a | a b c d), axis by axis
    in order."""
    r = int(truncate * sigma + 0.5)
    t = np.arange(-r, r + 1)
    w = np.exp(-0.5 * t ** 2 / sigma ** 2)
    w = torch.as_tensor(w / w.sum(), dtype=x.dtype, device=x.device)
    for dim in range(x.ndim - nd, x.ndim):
        n = x.shape[dim]
        i = np.arange(-r, n + r)
        i = np.where(i < 0, -i - 1, np.where(i >= n, 2 * n - 1 - i, i))
        xp = x.index_select(dim, torch.as_tensor(i, device=x.device))
        x = sum(w[j] * xp.narrow(dim, j, n) for j in range(2 * r + 1))
    return x


def _ssim(ref, frames, nd, win_size=7, data_range=None):
    """Mean SSIM of each frame against ``ref`` over their last ``nd``
    axes (vip_tpu distances.py:15), the sample covariance (win_size^nd
    samples) and the border of (win_size − 1) / 2 left out."""
    NP = win_size ** nd
    cov_norm = NP / (NP - 1)
    ux, uy = _gauss_filter(ref, nd), _gauss_filter(frames, nd)
    uxx = _gauss_filter(ref * ref, nd)
    uyy = _gauss_filter(frames * frames, nd)
    uxy = _gauss_filter(ref * frames, nd)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    for dim in range(S.ndim - nd, S.ndim):
        S = S.narrow(dim, pad, S.shape[dim] - 2 * pad)
    return S.reshape(S.shape[0], -1).mean(dim=-1)


def cube_distance(array, frame, mode="full", dist="sad", inradius=None,
                  width=None, mask=None, plot=True):
    """Distance or similarity of every frame of a cube to a reference
    frame: the frame of index ``frame``, a given frame, or the median
    frame for None (vip_tpu distances.py:42), in one batched pass on the
    cube's device (numpy input on :func:`~vip_tpu_torch.get_device`).
    ``mode`` 'full' compares whole frames, 'annulus' the pixels of the
    annulus (``inradius``, ``width``), 'mask' those where ``mask`` is set.
    As vip_tpu, 'mse' divides by ``len`` of the reference: its row count
    in 'full' mode. Returns a tensor of one value a frame; ``plot`` draws
    it (matplotlib, imported only then)."""
    cube = as_tensor(array)
    n = cube.shape[0]
    if isinstance(frame, int):
        frame_ref = cube[frame]
    elif isinstance(frame, (np.ndarray, torch.Tensor)):
        frame_ref = as_tensor(frame, cube.device, cube.dtype)
    elif frame is None:
        frame_ref = _median0(cube)
    else:
        raise TypeError("Input ref frame format not recognized")

    if mode == "full":
        frames = cube
    elif mode == "annulus":
        if inradius is None:
            raise ValueError("`Inradius` has not been set")
        if width is None:
            raise ValueError("`Width` has not been set")
        yy, xx = (torch.as_tensor(i, device=cube.device) for i in
                  get_annulus_segments(tuple(cube.shape[-2:]), inradius,
                                       width)[0])
        frame_ref, frames = frame_ref[yy, xx], cube[:, yy, xx]
    elif mode == "mask":
        if mask is None:
            raise ValueError("mask has not been set")
        keep = torch.as_tensor(np.asarray(
            mask.cpu() if isinstance(mask, torch.Tensor) else mask) != 0,
            device=cube.device)
        frame_ref, frames = frame_ref[keep], cube[:, keep]
    else:
        raise TypeError("Mode not recognized or missing parameters")

    nd = frame_ref.ndim
    diff = (frame_ref - frames).reshape(n, -1)
    if dist == "sad":
        lista = diff.abs().sum(dim=-1)
    elif dist == "euclidean":
        lista = torch.sqrt((diff ** 2).sum(dim=-1))
    elif dist == "mse":
        lista = (diff ** 2).sum(dim=-1) / frame_ref.shape[0]
    elif dist == "pearson":
        lista = _pearson(frame_ref.reshape(-1), frames.reshape(n, -1))
    elif dist == "spearman":
        lista = _pearson(_average_ranks(frame_ref.reshape(-1)),
                         _average_ranks(frames.reshape(n, -1)))
    elif dist == "ssim":
        lista = _ssim(frame_ref, frames, nd, win_size=7,
                      data_range=frame_ref.max() - frame_ref.min())
    else:
        raise ValueError("Distance not recognized")
    if plot:
        _plot_distances(lista.cpu().numpy(), frame, n, dist)
    return lista


def _plot_distances(lista, frame, n, dist):
    import matplotlib.pyplot as plt

    ylabels = {"sad": "SAD - Manhattan distance",
               "euclidean": "Euclidean distance",
               "pearson": "Pearson correlation coefficient",
               "spearman": "Spearman rank correlation coefficient",
               "mse": "Mean squared error",
               "ssim": "Structural Similarity Index"}
    _, ax = plt.subplots(figsize=(8, 4))
    if isinstance(frame, int):
        ax.vlines(frame, ymin=np.nanmin(lista), ymax=np.nanmax(lista),
                  colors="green", linestyles="dashed", lw=2, alpha=0.8,
                  label=f"Frame {frame}")
    ax.hlines(np.median(lista), xmin=-1, xmax=n + 1, colors="purple",
              alpha=0.3, linestyles="dashed",
              label=f"Median value : {np.median(lista):.3f}")
    ax.hlines(np.mean(lista), xmin=-1, xmax=n + 1, colors="green",
              alpha=0.3, linestyles="dashed",
              label=f"Mean value : {np.mean(lista):.3f}")
    ax.plot(np.arange(n), lista, "-", alpha=0.6)
    ax.plot(np.arange(n), lista, "o", alpha=0.4)
    ax.set_xlabel("Frame number")
    ax.set_ylabel(ylabels.get(dist, dist))
    ax.set_xlim(-1, n + 1)
    ax.minorticks_on()
    ax.legend(fancybox=True, framealpha=0.5, fontsize=12, loc="best")
    ax.grid(which="major", alpha=0.2)


def spectral_correlation(array, ann_width=2, r_in=1, r_out=None, pl_xy=None,
                         mask_r=4, fwhm=4, sp_fwhm_guess=3,
                         full_output=False):
    """Spectral correlation between the channels of an IFS cube in
    annuli of ``ann_width`` px, Eq. 7 of [GRE16] (vip_tpu
    distances.py:132): each annulus's channel-pair correlations in one
    batched product on the cube's device, the disks of ``mask_r``·``fwhm``
    around the companions ``pl_xy`` left out. Returns a (radius, channel,
    channel) tensor, and with ``full_output`` the spectral FWHM of each
    radius and channel from a host Gaussian fit (scipy ``curve_fit``)."""
    if not isinstance(ann_width, int) or not isinstance(r_in, int):
        raise TypeError("Inputs should be integers")
    if array.ndim != 3:
        raise TypeError("Input array should be 3D.")
    cube = as_tensor(array)
    n_ch, n_y, n_x = cube.shape
    n_r = min((n_y - 1) / 2., (n_x - 1) / 2.)
    if n_r % 1:
        raise TypeError("Input array y and x dimensions should be odd")
    if r_out is None:
        r_out = n_r

    test_rads = np.arange(r_in - 1, r_out - 1)
    n_rad = int(np.floor(test_rads.shape[0] / ann_width))
    sp_corr = torch.zeros((int(n_r), n_ch, n_ch), dtype=cube.dtype,
                          device=cube.device)
    mask_final = np.zeros((n_y, n_x))
    if pl_xy is not None:
        for xy in pl_xy:
            if not isinstance(xy, tuple):
                raise TypeError("Format of companions coordinates "
                                "incorrect")
            mask_final[get_circle(mask_final, radius=mask_r * fwhm, cy=xy[1],
                                  cx=xy[0], mode="ind")] = 1

    for ann in range(n_rad):
        inner_radius = r_in + (ann * ann_width)
        yy, xx = get_annulus_segments((n_y, n_x), inner_radius,
                                      ann_width)[0]
        keep = ~mask_final[yy, xx].astype(bool)
        matrix = cube[:, torch.as_tensor(yy[keep], device=cube.device),
                      torch.as_tensor(xx[keep], device=cube.device)]
        m2 = torch.nanmean(matrix[:, None, :] * matrix[None, :, :], dim=-1)
        diag = torch.sqrt(torch.diagonal(m2))
        sp_corr[r_in + ann * ann_width:r_in + (ann + 1) * ann_width] = \
            m2 / torch.outer(diag, diag)
    if not full_output:
        return sp_corr

    from scipy.optimize import curve_fit

    def gauss_1fp(x, *p):
        sig = p[0] * _GAUSSIAN_FWHM_TO_SIGMA
        return np.exp(-x ** 2 / (2. * sig ** 2))

    corr = sp_corr.cpu().double().numpy()
    sp_fwhm = np.zeros([int(n_r), n_ch])
    for ann in range(n_rad):
        r0 = r_in + ann * ann_width
        for zi in range(n_ch):
            y = corr[r0, zi] - np.amin(corr[r0, zi])
            coeff, _ = curve_fit(gauss_1fp, np.arange(n_ch) - zi,
                                 y / np.amax(y), p0=(sp_fwhm_guess,))
            sp_fwhm[r0:r0 + ann_width, zi] = coeff[0]
    return sp_corr, torch.as_tensor(sp_fwhm, device=cube.device)

"""S/N with small-sample statistics (Mawet+14) and S/N maps (port of
``vip_tpu.metrics.snr_source``).

The photometry and the per-pixel S/N of a map run batched on the image's
device (``ops.apertures``); the ring geometry of one position, the
statistics of a few apertures and the significance conversion are host
numpy and scipy, as in vip_tpu. S/N values are host floats; maps are
tensors on the image's device.
"""

import functools

import numpy as np
import torch
from scipy.stats import norm, t

from ..config.device import as_tensor
from ..config.timing import time_ini, timing
from ..config.utils_conf import check_array, sep as SEP
from ..ops.apertures import (aperture_flux, snrmap_engine,
                             snrmap_polar_engine)
from ..var.coords import dist, frame_center
from ..var.shapes import disk_coords, get_annulus_segments

__all__ = ["snr", "snr_multi", "snrmap", "snrmap_fast", "significance",
           "frame_report", "indep_ap_centers"]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def indep_ap_centers(array, source_xy, fwhm, exclude_negative_lobes=False,
                     exclude_theta_range=None, no_gap=False):
    """Ring of independent aperture centers through ``source_xy`` (vip_tpu
    snr_source.py:23; host geometry). Returns host (yy, xx)."""
    sourcex, sourcey = source_xy
    centery, centerx = frame_center(array)
    sep = dist(centery, centerx, float(sourcey), float(sourcex))
    theta_0 = np.rad2deg(np.arctan2(sourcey - centery, sourcex - centerx))

    if exclude_theta_range is not None:
        exc_theta_range = list(exclude_theta_range)
    if not sep > (fwhm / 2):
        raise RuntimeError("`source_xy` is too close to the frame center")

    sign = -1
    if exclude_theta_range is not None:
        if exc_theta_range[0] < theta_0 < exc_theta_range[1]:
            exc_theta_range[0] += 360
        while theta_0 < exc_theta_range[1]:
            theta_0 += 360
    theta = theta_0

    angle = np.arcsin(fwhm / 2.0 / sep) * 2
    number_apertures = int(np.floor(2 * np.pi / angle))
    if no_gap:
        number_apertures += 1

    yy = [sourcey - centery]
    xx = [sourcex - centerx]
    yy_all = np.zeros(number_apertures)
    xx_all = np.zeros(number_apertures)
    xx_all[0] = sourcex - centerx
    yy_all[0] = sourcey - centery
    cosangle = np.cos(angle)
    sinangle = np.sin(angle)

    for i in range(number_apertures - 1):
        xx_all[i + 1] = cosangle * xx_all[i] - sign * sinangle * yy_all[i]
        yy_all[i + 1] = cosangle * yy_all[i] + sign * sinangle * xx_all[i]
        theta += sign * np.rad2deg(angle)
        if exclude_negative_lobes and (i == 0 or i == number_apertures - 2):
            continue
        if exclude_theta_range is None or \
                (theta < exc_theta_range[0] or theta > exc_theta_range[1]):
            xx.append(cosangle * xx_all[i] - sign * sinangle * yy_all[i])
            yy.append(cosangle * yy_all[i] + sign * sinangle * xx_all[i])

    xx = np.array(xx) + centerx
    yy = np.array(yy) + centery
    return yy, xx


def _ring_snr(fluxes):
    """(f_source, background fluxes, S/N) of a ring's host fluxes."""
    f_source = fluxes[0].copy()
    bkg = fluxes[1:]
    n2 = bkg.shape[0]
    return f_source, bkg, (f_source - bkg.mean()) / (
        bkg.std(ddof=1) * np.sqrt(1 + (1 / n2)))


def snr(array, source_xy, fwhm, full_output=False, array2=None,
        use2alone=False, exclude_negative_lobes=False,
        exclude_theta_range=None, plot=False, verbose=False):
    """S/N of a test resolution element ([MAW14] eq. 9; vip_tpu
    snr_source.py:76): exact photometry of the ring on the frame's
    device, statistics on the host."""
    check_array(array, dim=2, msg="array")
    if not isinstance(source_xy, tuple):
        raise TypeError("`source_xy` must be a tuple of floats")
    if array2 is not None and array2.shape != array.shape:
        raise TypeError("`array2` has not the same shape as input array")

    sourcex, sourcey = source_xy
    yy, xx = indep_ap_centers(array, source_xy, fwhm,
                              exclude_negative_lobes, exclude_theta_range)
    rad = fwhm / 2.0
    fluxes = _host(aperture_flux(array, yy, xx, rad))
    if array2 is not None:
        fluxes2 = _host(aperture_flux(array2, yy, xx, rad))
        if use2alone:
            fluxes = np.concatenate(([fluxes[0]], fluxes2[:]))
        else:
            fluxes = np.concatenate((fluxes, fluxes2))
    f_source, fluxes, snr_vale = _ring_snr(fluxes)
    backgr_apertures_std = fluxes.std(ddof=1)

    if verbose:
        print(f"S/N for the given pixel = {snr_vale:.3f}")
        print(f"Integrated flux in FWHM test aperture = {f_source:.3f}")
        print(f"Mean of background apertures integrated fluxes = "
              f"{fluxes.mean():.3f}")
        print(f"Std-dev of background apertures integrated fluxes = "
              f"{backgr_apertures_std:.3f}")
    if plot:
        import matplotlib.pyplot as plt

        _, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(_host(array), origin="lower", interpolation="nearest",
                  alpha=0.5, cmap="gray")
        for yi, xi in zip(yy, xx):
            ax.add_patch(plt.Circle((xi, yi), radius=rad, color="r",
                                    fill=False, alpha=0.8))
            ax.add_patch(plt.Circle((xi, yi), radius=0.8, color="r",
                                    fill=True, alpha=0.5))
        ax.add_patch(plt.Circle((sourcex, sourcey), radius=0.7, color="b",
                                fill=True, alpha=0.5))
        ax.grid(False)
        plt.show()

    if full_output:
        return sourcey, sourcex, f_source, fluxes, snr_vale
    return snr_vale


def snr_multi(array, xs, ys, fwhm, exclude_negative_lobes=False,
              exclude_theta_range=None):
    """S/N and source aperture flux at several test positions with one
    batched photometry call (vip_tpu snr_source.py:138). Returns host
    (snr_values, source_fluxes), both (len(xs),)."""
    array = as_tensor(array)
    rad = fwhm / 2.0
    all_yy, all_xx, counts = [], [], []
    for x_, y_ in zip(xs, ys):
        yy, xx = indep_ap_centers(array, (x_, y_), fwhm,
                                  exclude_negative_lobes,
                                  exclude_theta_range)
        all_yy.append(yy)
        all_xx.append(xx)
        counts.append(len(yy))
    if not all_yy:
        return np.empty(0), np.empty(0)
    fluxes_all = _host(aperture_flux(array, np.concatenate(all_yy),
                                     np.concatenate(all_xx), rad))
    snrs = np.empty(len(counts))
    f_sources = np.empty(len(counts))
    ofs = 0
    for i, cnt in enumerate(counts):
        f_sources[i], _, snrs[i] = _ring_snr(fluxes_all[ofs:ofs + cnt])
        ofs += cnt
    return snrs, f_sources


def _annulus_pixels(array, fwhm):
    """Host (yy, xx) of the S/N map's working annulus [fwhm, size/2 −
    0.5·fwhm): vip_tpu keeps the pixels where the annulus *mask mode*
    (the frame times the annulus) is non-zero, so exact zeros drop out."""
    sizey, sizex = array.shape
    width = min(sizey, sizex) / 2 - 1.5 * fwhm
    yy, xx = get_annulus_segments((sizey, sizex), fwhm, width)[0]
    vals = _host(array[torch.as_tensor(yy, device=array.device),
                       torch.as_tensor(xx, device=array.device)])
    keep = vals != 0
    return yy[keep], xx[keep]


def snrmap(array, fwhm, approximated=False, plot=False, known_sources=None,
           nproc=None, array2=None, use2alone=False,
           exclude_negative_lobes=False, verbose=True, **kwargs):
    """S/N map: the Mawet+14 S/N at every pixel of the working annulus
    (vip_tpu snr_source.py:181), batched on the frame's device. Returns a
    tensor on that device. ``nproc`` is accepted for API parity."""
    if verbose:
        start_time = time_ini()
    check_array(array, dim=2, msg="array")
    array = as_tensor(array)
    if array2 is not None:
        array2 = as_tensor(array2, array.device, array.dtype)
    snrmap_array = torch.zeros_like(array)
    yy, xx = _annulus_pixels(array, fwhm)
    cy, cx = frame_center(array)

    def put(yv, xv, vals):
        snrmap_array[torch.as_tensor(yv, device=array.device),
                     torch.as_tensor(xv, device=array.device)] = vals

    if known_sources is None:
        if approximated:
            vals = _snrmap_approx(array, yy, xx, fwhm, cy, cx)
        else:
            vals = _snrmap_exact(array, yy, xx, fwhm, cy, cx, array2=array2,
                                 use2alone=use2alone,
                                 exclude_negative_lobes=
                                 exclude_negative_lobes)
        put(yy, xx, vals)
    else:
        # mask the known sources with the annulus MAD, then the S/N of the
        # masked annuli on the masked frame (vip_tpu snr_source.py:210)
        if not isinstance(known_sources, tuple):
            raise TypeError("`known_sources` must be a tuple or tuple of "
                            "tuples")
        host = _host(array)
        source_mask = np.zeros_like(host)
        if isinstance(known_sources[0], tuple):
            for coor in known_sources:
                source_mask[coor[::-1]] = 1
        elif isinstance(known_sources[0], int):
            source_mask[known_sources[1], known_sources[0]] = 1
        else:
            raise TypeError("`known_sources` seems to have wrong type. It "
                            "must be a tuple of ints or tuple of tuples (of "
                            "ints)")
        if source_mask[source_mask == 1].shape[0] > 50:
            raise RuntimeError("Input source mask is too crowded (check its "
                               "validity)")
        from scipy.stats import median_abs_deviation

        soury, sourx = np.where(source_mask == 1)
        sources = [(y, x) for y, x in zip(soury, sourx)
                   if int(dist(cy, cx, int(y), int(x))) < cy - np.ceil(fwhm)]
        masked = host.copy()
        coor_ann = []
        kw = dict(array2=array2, use2alone=use2alone,
                  exclude_negative_lobes=exclude_negative_lobes)
        for y, x in sources:
            radd = dist(cy, cx, int(y), int(x))
            anny, annx = get_annulus_segments(host, int(radd - fwhm),
                                              int(np.round(3 * fwhm)))[0]
            ciry, cirx = disk_coords((y, x), int(np.ceil(fwhm)), host.shape)
            masked[ciry, cirx] = median_abs_deviation(host[anny, annx],
                                                      scale=1.0)
            coor_ann_src = [(xi, yi) for (xi, yi) in zip(annx, anny)
                            if (xi, yi) not in zip(cirx, ciry)]
            ca = np.array(coor_ann_src)
            put(ca[:, 1], ca[:, 0], _snrmap_exact(
                as_tensor(masked, array.device, array.dtype), ca[:, 1],
                ca[:, 0], fwhm, cy, cx, **kw))
            coor_ann += coor_ann_src
        cr = np.array([(x, y) for (x, y) in zip(xx, yy)
                       if (x, y) not in coor_ann])
        put(cr[:, 1], cr[:, 0], _snrmap_exact(array, cr[:, 1], cr[:, 0],
                                               fwhm, cy, cx, **kw))

    if plot:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.imshow(_host(snrmap_array), origin="lower")
        plt.colorbar()
        plt.title("S/N map")
        plt.show()
    if verbose:
        print(f"S/N map created on {array.device} (batched)")
        timing(start_time)
    return snrmap_array


def _snrmap_exact(array, yy, xx, fwhm, cy, cx, array2=None, use2alone=False,
                  exclude_negative_lobes=False):
    """Every requested pixel through the batched S/N engine; the caller
    keeps to the working annulus (pixels within fwhm/2 + 1 of the center
    break the ring construction)."""
    seps = np.hypot(np.asarray(yy) - cy, np.asarray(xx) - cx)
    n_max = int(np.floor(2 * np.pi / (2 * np.arcsin(fwhm / 2.0
                                                     / seps.max()))))
    window = int(2 * (fwhm / 2.0) + 4)
    return snrmap_engine(array, np.asarray(yy, np.float64),
                         np.asarray(xx, np.float64), float(cy), float(cx),
                         float(fwhm), n_max, window,
                         exclude_negative_lobes=bool(exclude_negative_lobes),
                         image2=array2, use2alone=bool(use2alone))


def _circle_perimeter(cy, cx, radius):
    """Midpoint (Bresenham) circle perimeter coordinates
    (skimage.draw.circle_perimeter semantics)."""
    yy, xx = [], []
    y = radius
    x = 0
    d = 3 - 2 * radius
    while y >= x:
        for dy, dx in ((y, x), (x, y), (-x, y), (-y, x),
                       (-y, -x), (-x, -y), (x, -y), (y, -x)):
            yy.append(cy + dy)
            xx.append(cx + dx)
        if d < 0:
            d += 4 * x + 6
        else:
            d += 4 * (x - y) + 10
            y -= 1
        x += 1
    coords = np.unique(np.column_stack([yy, xx]), axis=0)
    return coords[:, 0], coords[:, 1]


@functools.lru_cache(maxsize=8)
def _approx_geometry(shape, cy, cx, r, yy_bytes, xx_bytes):
    """The static geometry of :func:`_snrmap_approx` for the pixels
    (yy, xx): the (Bresenham) rings through them, as an (R, M) array of
    flat pixel indices with its validity mask; each pixel's ring row; and
    the (K, O) flat indices of the pixels under each pixel's aperture
    (|d|² < r², skimage.draw.disk) that lie on its own ring, with their
    mask. Host numpy, cached: a completeness search asks again and again
    for the same pixels."""
    sizey, sizex = shape
    yy = np.frombuffer(yy_bytes, dtype=np.int64)
    xx = np.frombuffer(xx_bytes, dtype=np.int64)
    irad = np.hypot(yy - cy, xx - cx).astype(int)
    radii, row = np.unique(irad, return_inverse=True)
    rings = []
    for ir in radii:
        py, px = _circle_perimeter(int(cy), int(cx), int(ir))
        keep = (py >= 0) & (py < sizey) & (px >= 0) & (px < sizex)
        rings.append(py[keep] * sizex + px[keep])
    width = max(len(f) for f in rings)
    ring_idx = np.zeros((len(rings), width), dtype=np.int64)
    ring_ok = np.zeros((len(rings), width), dtype=bool)
    for i, f in enumerate(rings):
        ring_idx[i, :len(f)] = f
        ring_ok[i, :len(f)] = True

    ro = int(np.ceil(r))
    oy, ox = np.mgrid[-ro:ro + 1, -ro:ro + 1]
    inside = oy ** 2 + ox ** 2 < r ** 2
    ay = yy[:, None] + oy[inside][None, :]
    ax = xx[:, None] + ox[inside][None, :]
    in_frame = (ay >= 0) & (ay < sizey) & (ax >= 0) & (ax < sizex)
    ap_flat = np.where(in_frame, ay * sizex + ax, 0)
    # on the pixel's own ring: its (ring, flat pixel) key among the rings'
    keys = np.concatenate([i * sizey * sizex + f
                           for i, f in enumerate(rings)])
    on_ring = in_frame & np.isin(row[:, None] * sizey * sizex + ap_flat, keys)
    return ring_idx, ring_ok, row, ap_flat, on_ring


def _middle(sorted_vals, counts):
    """numpy's median of the first ``counts[i]`` values of each sorted
    row: the mean of the two middle values for an even count."""
    lo = ((counts - 1) // 2)[:, None]
    hi = (counts // 2)[:, None]
    return 0.5 * (sorted_vals.gather(1, lo) + sorted_vals.gather(1, hi))[:, 0]


def _snrmap_approx(array, yy, xx, fwhm, cy, cx):
    """Approximated S/N proxy (vip_tpu snr_source.py:329): a tophat
    convolution, then, for each pixel, the statistics of the convolved
    values on the (Bresenham) ring through it, with the ring's pixels
    inside the pixel's own aperture replaced by the ring's MAD.

    vip_tpu copies the frame once per pixel; here every ring's sum, sum
    of squares (about the ring mean), median and MAD are row reductions
    of one padded (rings, ring pixels) array, and each pixel subtracts
    the values under its aperture and adds as many MADs: a few batched
    ops on the frame's device in its dtype, over geometry built once on
    the host (:func:`_approx_geometry`)."""
    from ..var.filters import convolve_with_mask

    r = fwhm / 2.0
    size = int(2 * np.ceil(r) + 1)
    yk, xk = np.mgrid[:size, :size] - size // 2
    kernel = ((yk ** 2 + xk ** 2) <= r ** 2).astype(float)
    kernel /= kernel.sum()
    conv = convolve_with_mask(array, kernel, interpolate_nan=True).reshape(-1)
    yy = np.ascontiguousarray(yy, dtype=np.int64)
    xx = np.ascontiguousarray(xx, dtype=np.int64)
    ring_idx, ring_ok, row, ap_flat, on_ring = (
        torch.as_tensor(a, device=array.device) for a in _approx_geometry(
            tuple(array.shape), int(cy), int(cx), float(r), yy.tobytes(),
            xx.tobytes()))

    ring = conv[ring_idx]
    m = ring_ok.sum(dim=1)
    mu = torch.where(ring_ok, ring, 0.0).sum(dim=1) / m
    srt = torch.where(ring_ok, ring, torch.inf).sort(dim=1).values
    med = _middle(srt, m)
    dev = torch.where(ring_ok, (ring - med[:, None]).abs(), torch.inf)
    mad = _middle(dev.sort(dim=1).values, m) - mu         # about the mean
    v = torch.where(ring_ok, ring - mu[:, None], 0.0)
    s1_ring, s2_ring = v.sum(dim=1), (v * v).sum(dim=1)

    under = torch.where(on_ring, conv[ap_flat] - mu[row][:, None], 0.0)
    c = on_ring.sum(dim=1).to(conv.dtype)
    s1 = s1_ring[row] - under.sum(dim=1) + c * mad[row]
    s2 = s2_ring[row] - (under * under).sum(dim=1) + c * mad[row] ** 2
    n = m[row].to(conv.dtype)
    mean = s1 / n
    var = (s2 - n * mean * mean) / (n - 1)
    rad = torch.as_tensor(np.hypot(yy - cy, xx - cx), dtype=conv.dtype,
                          device=conv.device)
    n2 = (2 * np.pi * rad) / fwhm - 1
    noise = torch.sqrt(var) * torch.sqrt(1 + (1 / n2))
    pix = torch.as_tensor(yy * array.shape[1] + xx, device=conv.device)
    return (conv[pix] - (mean + mu[row])) / noise


def significance(snr, rad, fwhm, n_ap=None, student_to_gauss=True,
                 verbose=True):
    """Student S/N ↔ Gaussian significance (vip_tpu snr_source.py:371)."""
    if n_ap is None:
        n_ap = (rad / fwhm) * 2 * np.pi - 2
    if student_to_gauss:
        cdf = t.cdf(snr, n_ap)
        sig = norm.ppf(cdf)
        if np.any(cdf == 1.0):
            print("Warning high S/N! cdf>0.9999999999999999 is rounded to 1")
            print("Returning 8.2 sigma, but quote significance > 8.2 sigma.")
            return 8.2
        if verbose:
            print(f"At a separation of {rad:.1f} px ({rad / fwhm:.1f} FWHM), "
                  f"S/N = {snr:.1f} corresponds to a {sig:.1f}-sigma "
                  "detection in terms of Gaussian false alarm probability.")
    else:
        sig = t.ppf(norm.cdf(snr), n_ap)
        if verbose:
            print(f"At a separation of {rad:.1f} px ({rad / fwhm:.1f} FWHM), "
                  f"a {snr:.1f}-sigma detection in terms of Gaussian false "
                  f"alarm probability translates into a Student S/N = "
                  f"{sig:.1f}.")
    return sig


def frame_report(array, fwhm, source_xy=None, verbose=True, **snr_arguments):
    """Flux and S/N of candidate companions in a frame (vip_tpu
    snr_source.py:399)."""
    if array.ndim != 2:
        raise TypeError("Array is not 2d.")
    array = as_tensor(array)
    obj_flux = []
    meansnr_pixels = []
    snr_centpx = []

    def _one(x, y):
        flux = float(_host(aperture_flux(array, np.array([y]),
                                         np.array([x]), fwhm / 2.0))[0])
        yy, xx = disk_coords((y, x), fwhm / 2, tuple(array.shape))
        snr_pixels = [snr(array, (x_, y_), fwhm, plot=False, verbose=False)
                      for y_, x_ in zip(yy, xx)]
        pxsnr = snr(array, (x, y), fwhm, plot=False, verbose=False)
        return flux, np.mean(snr_pixels), np.std(snr_pixels, ddof=1), pxsnr, \
            np.max(snr_pixels)

    if source_xy is not None:
        if isinstance(source_xy, (list, tuple)):
            if not isinstance(source_xy[0], tuple):
                source_xy = [source_xy]
        else:
            raise TypeError("`source_xy` must be a tuple of floats or tuple "
                            "of tuples")
        for xy in source_xy:
            x, y = xy
            flux, mean_s, std_s, pxsnr, max_s = _one(x, y)
            obj_flux.append(flux)
            meansnr_pixels.append(mean_s)
            snr_centpx.append(pxsnr)
            if verbose:
                print(SEP)
                print(f"Coords of chosen px (X,Y) = {x:.1f}, {y:.1f}")
                print(f"Flux in a centered 1xFWHM circular aperture = "
                      f"{flux:.3f}")
                print(f"Central pixel S/N = {pxsnr:.3f}")
                print(SEP)
                print("Inside a centered 1xFWHM circular aperture:")
                print(f"Mean S/N (shifting the aperture center) = "
                      f"{mean_s:.3f}")
                print(f"Max S/N (shifting the aperture center) = {max_s:.3f}")
                print(f"stddev S/N (shifting the aperture center) = "
                      f"{std_s:.3f}")
                print("")
    else:
        snr_map = _host(snrmap(array, fwhm, verbose=False, **snr_arguments))
        y, x = np.where(snr_map == np.nanmax(snr_map))
        y, x = y[0], x[0]
        source_xy = (x, y)
        flux, mean_s, std_s, pxsnr, max_s = _one(x, y)
        obj_flux.append(flux)
        meansnr_pixels = mean_s
        snr_centpx.append(pxsnr)
        if verbose:
            print(SEP)
            print(f"Coords of Max px (X,Y) = {x:.1f}, {y:.1f}")
            print(f"Flux in a centered 1xFWHM circular aperture = {flux:.3f}")
            print(f"Central pixel S/N = {pxsnr:.3f}")
            print(SEP)

    return source_xy, obj_flux, snr_centpx, meansnr_pixels


def snrmap_fast(array, fwhm, n_theta=0, exclude_negative_lobes=False,
                verbose=False):
    """Fast full-frame S/N map (vip_tpu snr_source.py:466): the polar
    engine of ``ops.apertures`` in float32, as vip_tpu runs it. Accuracy
    against the exact :func:`snrmap`: ~0.99 correlation, ~0.2 S/N rms.
    Returns a float32 tensor on the frame's device."""
    if verbose:
        start_time = time_ini()
    image = as_tensor(array, dtype=torch.float32)
    out = snrmap_polar_engine(image, float(fwhm), n_theta=int(n_theta),
                              exclude_negative_lobes=bool(
                                  exclude_negative_lobes))
    if verbose:
        print(f"Fast S/N map created on {image.device}")
        timing(start_time)
    return out

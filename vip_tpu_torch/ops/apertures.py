"""Exact circular-aperture photometry and the Student-t S/N, batched on
the image's device (port of ``vip_tpu.ops.apertures``).

The exact unit-pixel/circle overlap area is evaluated analytically from
signed quadrant-corner areas (photutils' 'exact' method) over a (W, W)
window around each, possibly fractional, aperture center, so the fluxes
of many apertures are one batched gather and sum. The Mawet+14 ring of
independent apertures has a closed form (aperture i is the source vector
rotated by i·2·asin(fwhm/2/sep), clockwise), so the S/N of many positions
is one batch too (:func:`snr_at`); :func:`snrmap_engine` runs it over the
pixels of a map in chunks that bound the working set.

The polar engine (:func:`snrmap_polar_engine`) is the fast S/N map: the
aperture flux at every integer center is one convolution with the exact
disc-overlap kernel, resampled to a polar grid, whose ring sums are
Fourier combs.
"""

import math

import numpy as np
import torch

from ..config.device import as_tensor

__all__ = ["aperture_flux", "aperture_flux_images", "snr_at",
           "snrmap_engine", "circle_overlap_window", "ring_aperture_centers",
           "snrmap_polar_engine", "polar_snr_rows", "polar_snr_to_cart"]


def _quadrant_corner_area(x, y, r):
    """Area of the circle of radius r at the origin ∩ [0,x]×[0,y], for
    x, y >= 0 (vip_tpu apertures.py:26)."""
    x = x.clamp(max=r)
    y = y.clamp(max=r)
    corner_in = x * x + y * y <= r * r

    def antideriv(t):
        # (r-t)(r+t) and atan2 avoid the cancellation of r² − t² and
        # arcsin(t/r) near t = r
        t = t.clamp(-r, r)
        s = torch.sqrt(((r - t) * (r + t)).clamp(min=0.0))
        return 0.5 * (t * s + r * r * torch.atan2(t, s))

    tstar = torch.sqrt(((r - y) * (r + y)).clamp(min=0.0))
    a1 = y * torch.minimum(x, tstar)
    hi = torch.maximum(x, tstar)
    a2 = antideriv(hi) - antideriv(tstar)
    return torch.where(corner_in, x * y, a1 + a2)


def _s_area(x, y, r):
    """Signed area of the circle of radius r at the origin ∩ the
    rectangle between the origin and the corner (x, y)."""
    return torch.sign(x) * torch.sign(y) * _quadrant_corner_area(
        x.abs(), y.abs(), r)


def circle_overlap_window(cy, cx, r, window):
    """Exact overlap fractions of the pixels of a (W, W) window with the
    circle of radius ``r`` at each center (cy, cx) (vip_tpu
    apertures.py:56). ``cy``, ``cx``: (K,) tensors. Returns (weights
    (K, W, W), y0 (K,), x0 (K,)), (y0, x0) the integer pixel of each
    window's [0, 0] element.

    A pixel's overlap is the signed corner areas S at its four corners,
    S(x1, y1) − S(x0, y1) − S(x1, y0) + S(x0, y0); neighbouring pixels
    share corners, so S is evaluated once on the (W+1)² corner lattice."""
    W = window
    y0 = torch.floor(cy).long() - W // 2
    x0 = torch.floor(cx).long() - W // 2
    ar = torch.arange(W + 1, device=cy.device)
    yc = ((y0[:, None] + ar).to(cy.dtype) - 0.5 - cy[:, None])[:, :, None]
    xc = ((x0[:, None] + ar).to(cx.dtype) - 0.5 - cx[:, None])[:, None, :]
    S = _s_area(xc, yc, r)                       # S[k, i, j]: (x_j, y_i)
    w = S[:, 1:, 1:] - S[:, 1:, :-1] - S[:, :-1, 1:] + S[:, :-1, :-1]
    return w, y0, x0


def _aperture_flux_core(image, ys, xs, r, window):
    """Fluxes (K,) of ``image`` in the circles of radius r at (ys, xs)."""
    ny, nx = image.shape
    w, y0, x0 = circle_overlap_window(ys, xs, r, window)
    ar = torch.arange(window, device=image.device)
    rows = y0[:, None] + ar
    cols = x0[:, None] + ar
    inside = (((rows >= 0) & (rows < ny))[:, :, None]
              & ((cols >= 0) & (cols < nx))[:, None, :])
    patch = image[rows.clamp(0, ny - 1)[:, :, None],
                  cols.clamp(0, nx - 1)[:, None, :]]
    return torch.where(inside, patch * w, 0.0).sum(dim=(1, 2))


def _centers(v, image):
    return as_tensor(np.asarray(v, dtype=np.float64).reshape(-1)
                     if not isinstance(v, torch.Tensor) else v.reshape(-1),
                     image.device, image.dtype)


def aperture_flux(image, ys, xs, r, window=None):
    """Exact-aperture fluxes of ``image`` at (k,) centers (ys, xs), radius
    ``r`` (vip_tpu apertures.py:127). Apertures fully inside the frame
    are exact; windows are clipped at the frame edge (photutils' zero
    contribution outside the image). Returns a (k,) tensor on the image's
    device."""
    if window is None:
        window = int(2 * float(r) + 4)
    image = as_tensor(image)
    return _aperture_flux_core(image, _centers(ys, image),
                               _centers(xs, image), float(r), window)


def aperture_flux_images(images, ys, xs, r, window=None):
    """Exact-aperture fluxes on a stack of images (vip_tpu
    apertures.py:101): ``images`` (p, ny, nx); ``ys``, ``xs``: p sequences
    of per-image centers, possibly ragged. Returns a list of p (k_i,)
    tensors."""
    images = as_tensor(images)
    return [aperture_flux(images[i], ys[i], xs[i], r, window)
            for i in range(images.shape[0])]


def ring_aperture_centers(sourcey, sourcex, cy, cx, fwhm, n_max):
    """Centers of the Mawet+14 rings of independent apertures through the
    (K,) sources (closed form of vip_tpu apertures.py:156; clockwise,
    source first). Returns (ys (K, n_max), xs (K, n_max), n_apertures
    (K,)): entry i of a ring is valid where i < n_apertures.

    The geometry is float64 whatever the sources' dtype, and the centers
    come back in that dtype: the aperture count is a floor, which float32
    rounding flips where 2π/angle is an integer (6 apertures at sep = fwhm
    became 5 on a float32 frame)."""
    dtype = sourcey.dtype
    dy = sourcey.double() - cy
    dx = sourcex.double() - cx
    sep = torch.hypot(dy, dx)
    angle = 2 * torch.arcsin(fwhm / 2.0 / sep)
    number_apertures = torch.floor(2 * math.pi / angle).long()
    i = torch.arange(n_max, device=sourcey.device, dtype=torch.float64)
    ia = i[None, :] * angle[:, None]
    ca, sa = torch.cos(ia), torch.sin(ia)
    xs = ca * dx[:, None] + sa * dy[:, None] + cx
    ys = ca * dy[:, None] - sa * dx[:, None] + cy
    return ys.to(dtype), xs.to(dtype), number_apertures


def snr_at(image, sourcey, sourcex, cy, cx, fwhm, n_max, window,
           exclude_negative_lobes=False, image2=None, use2alone=False):
    """Student-t corrected S/N at (K,) positions (vip_tpu apertures.py:178,
    batched): ring of independent apertures, exact photometry,
    S/N = (f0 − mean(bkg)) / (std(bkg, ddof=1)·sqrt(1 + 1/n2)). Returns
    (source fluxes (K,), S/N (K,))."""
    ys, xs, n_ap = ring_aperture_centers(sourcey, sourcex, cy, cx, fwhm,
                                         n_max)
    K = ys.shape[0]
    r = fwhm / 2.0
    fluxes = _aperture_flux_core(image, ys.reshape(-1), xs.reshape(-1), r,
                                 window).reshape(K, n_max)
    idx = torch.arange(n_max, device=image.device)
    valid = idx[None, :] < n_ap[:, None]
    if exclude_negative_lobes:
        valid = valid & (idx != 1)[None, :] & (idx[None, :]
                                               != (n_ap - 1)[:, None])
    f_source = fluxes[:, 0]
    bkg_valid = valid & (idx != 0)[None, :]
    if image2 is not None:
        fluxes2 = _aperture_flux_core(image2, ys.reshape(-1),
                                      xs.reshape(-1), r,
                                      window).reshape(K, n_max)
        if use2alone:
            f_all, v_all = fluxes2, bkg_valid
        else:
            f_all = torch.cat([fluxes, fluxes2], dim=1)
            v_all = torch.cat([bkg_valid, bkg_valid], dim=1)
    else:
        f_all, v_all = fluxes, bkg_valid
    n2 = v_all.sum(dim=1).to(image.dtype)
    mean_bkg = torch.where(v_all, f_all, 0.0).sum(dim=1) / n2
    var = torch.where(v_all, (f_all - mean_bkg[:, None]) ** 2,
                      0.0).sum(dim=1) / (n2 - 1)
    std = torch.sqrt(var)
    return f_source, (f_source - mean_bkg) / (std * torch.sqrt(1 + 1.0 / n2))


def snrmap_engine(image, coords_y, coords_x, cy, cx, fwhm, n_max, window,
                  exclude_negative_lobes=False, image2=None,
                  use2alone=False, chunk=4096):
    """S/N at many positions (vip_tpu apertures.py:220), ``chunk``
    positions a batch: a batch's apertures are chunk x n_max windows of
    window² pixels, so the chunk bounds the working set of a 512² map.
    Returns a tensor on the image's device."""
    ys = as_tensor(coords_y, image.device, image.dtype).reshape(-1)
    xs = as_tensor(coords_x, image.device, image.dtype).reshape(-1)
    out = torch.empty_like(ys)
    step = ys.shape[0] if chunk is None else chunk
    for s in range(0, ys.shape[0], max(step, 1)):
        out[s:s + step] = snr_at(
            image, ys[s:s + step], xs[s:s + step], cy, cx, fwhm, n_max,
            window, exclude_negative_lobes=exclude_negative_lobes,
            image2=image2, use2alone=use2alone)[1]
    return out


# ---------------------------------------------------------------------------
# polar fast S/N map: ring statistics as Fourier comb sums
# ---------------------------------------------------------------------------
def _aperture_kernel(r_ap):
    """Exact-overlap photometry kernel (vip_tpu apertures.py:250): the area
    of the disc of radius ``r_ap`` centered on an integer pixel within each
    neighboring pixel. Host float64."""
    r = float(r_ap)

    def antideriv(t):
        t = np.clip(t, -r, r)
        s = np.sqrt(np.maximum((r - t) * (r + t), 0.0))
        return 0.5 * (t * s + r * r * np.arctan2(t, s))

    def corner(x, y):
        x = np.minimum(x, r)
        y = np.minimum(y, r)
        inside = x * x + y * y <= r * r
        tstar = np.sqrt(np.maximum((r - y) * (r + y), 0.0))
        a1 = y * np.minimum(x, tstar)
        a2 = antideriv(np.maximum(x, tstar)) - antideriv(tstar)
        return np.where(inside, x * y, a1 + a2)

    def s_area(x, y):
        return np.sign(x) * np.sign(y) * corner(np.abs(x), np.abs(y))

    half = int(np.ceil(r)) + 1
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1]
    x0, x1 = xx - 0.5, xx + 0.5
    y0, y1 = yy - 0.5, yy + 0.5
    return (s_area(x1, y1) - s_area(x0, y1) - s_area(x1, y0)
            + s_area(x0, y0))


def _center(n):
    return n / 2 if n % 2 == 0 else (n - 1) / 2


def snrmap_polar_engine(image, fwhm, n_theta=0,
                        exclude_negative_lobes=False):
    """Full-frame Mawet+14 S/N map through the polar domain (vip_tpu
    apertures.py:285): (1) the exact aperture flux at every integer center
    is one convolution with the disc-overlap kernel; (2) bilinear
    resampling to a polar grid; (3) per radius row, the ring sums of the
    flux and its square are Fourier combs; (4) the Student-t S/N mapped
    back to the frame. Interpolation-limited (~1% of the exact engine)."""
    ny, nx = image.shape
    cy, cx = _center(ny), _center(nx)
    r_ap = fwhm / 2.0
    n_r = int(min(cy, cx, ny - cy, nx - cx)) - int(np.ceil(r_ap)) - 1
    if n_theta == 0:
        n_theta = 4 * max(ny, nx)
    radii = torch.arange(1, n_r + 1, dtype=image.dtype, device=image.device)
    snr_p = polar_snr_rows(image, radii, fwhm, n_theta,
                           exclude_negative_lobes)
    return polar_snr_to_cart(snr_p, (ny, nx), fwhm, n_theta)


def polar_snr_rows(image, radii, fwhm, n_theta, exclude_negative_lobes):
    """Steps (1)-(3) of the polar engine for the given radius rows
    (vip_tpu apertures.py:311). Returns (len(radii), n_theta)."""
    ny, nx = image.shape
    cy, cx = _center(ny), _center(nx)
    r_ap = fwhm / 2.0
    dev, dt = image.device, image.dtype

    # (1) exact aperture flux at every integer center: one correlation
    kern = torch.as_tensor(_aperture_kernel(r_ap), dtype=dt, device=dev)
    kh = kern.shape[0] // 2
    AF = torch.nn.functional.conv2d(image[None, None], kern[None, None],
                                    padding=kh)[0, 0]

    # (2) polar resampling (bilinear)
    thetas = torch.arange(n_theta, dtype=dt, device=dev) * (
        2 * math.pi / n_theta)
    yy = cy + radii[:, None] * torch.sin(thetas)[None, :]
    xx = cx + radii[:, None] * torch.cos(thetas)[None, :]
    y0 = torch.floor(yy).long()
    x0 = torch.floor(xx).long()
    wy = yy - y0
    wx = xx - x0

    def samp(dy, dx):
        return AF[(y0 + dy).clamp(0, ny - 1), (x0 + dx).clamp(0, nx - 1)]

    AFp = ((1 - wy) * (1 - wx) * samp(0, 0) + (1 - wy) * wx * samp(0, 1)
           + wy * (1 - wx) * samp(1, 0) + wy * wx * samp(1, 1))

    # (3) ring statistics per radius row via Fourier combs: apertures every
    # angle = 2 asin(fwhm/2/r), n = floor(2π/angle) of them
    ap_angle = 2 * torch.arcsin(r_ap / radii)
    n_ap = torch.clamp(torch.floor(2 * math.pi / ap_angle), min=3.0)
    k = torch.fft.fftfreq(n_theta, d=1.0 / n_theta, dtype=dt, device=dev)
    shift_frac = ap_angle / (2 * math.pi)
    phase = 2j * math.pi * k[None, :] * shift_frac[:, None]
    num = 1.0 - torch.exp(-phase * n_ap[:, None])
    den = 1.0 - torch.exp(-phase)
    comb = torch.where(den.abs() > 1e-9, num / den,
                       n_ap[:, None].to(num.dtype))

    F1 = torch.fft.fft(AFp, dim=1)
    F2 = torch.fft.fft(AFp * AFp, dim=1)
    S1 = torch.fft.ifft(F1 * comb, dim=1).real
    S2 = torch.fft.ifft(F2 * comb, dim=1).real

    f0 = AFp
    if exclude_negative_lobes:
        # also remove the two apertures next to the source
        ph = torch.exp(-2j * math.pi * k[None, :] * shift_frac[:, None])
        S1 = (S1 - torch.fft.ifft(F1 * ph, dim=1).real
              - torch.fft.ifft(F1 * ph.conj(), dim=1).real)
        S2 = (S2 - torch.fft.ifft(F2 * ph, dim=1).real
              - torch.fft.ifft(F2 * ph.conj(), dim=1).real)
        n2 = n_ap[:, None] - 3.0
    else:
        n2 = n_ap[:, None] - 1.0
    S1b = S1 - f0
    S2b = S2 - f0 * f0
    mean_bkg = S1b / n2
    var = (S2b / n2 - mean_bkg ** 2).clamp(min=0.0) * n2 / (n2 - 1.0)
    den = torch.sqrt(var) * torch.sqrt(1.0 + 1.0 / n2)
    return torch.where(den > 0,
                       (f0 - mean_bkg) / torch.where(den > 0, den, 1.0), 0.0)


def polar_snr_to_cart(snr_p, shape, fwhm, n_theta):
    """Step (4): the (n_r, n_theta) polar S/N grid back to a (ny, nx)
    frame, bilinear in polar coordinates (vip_tpu apertures.py:386)."""
    ny, nx = shape
    cy, cx = _center(ny), _center(nx)
    n_r = snr_p.shape[0]
    dev, dt = snr_p.device, snr_p.dtype
    gy = torch.arange(ny, device=dev, dtype=dt)[:, None] - cy
    gx = torch.arange(nx, device=dev, dtype=dt)[None, :] - cx
    rr = torch.hypot(gy, gx)
    tt = torch.remainder(torch.atan2(gy, gx), 2 * math.pi)
    ri = rr - 1.0
    ti = tt / (2 * math.pi / n_theta)
    r0 = torch.floor(ri).long().clamp(0, n_r - 2)
    t0i = torch.remainder(torch.floor(ti).long(), n_theta)
    wr = (ri - r0).clamp(0.0, 1.0)
    wt = ti - torch.floor(ti)
    t1i = (t0i + 1) % n_theta
    out = ((1 - wr) * (1 - wt) * snr_p[r0, t0i]
           + (1 - wr) * wt * snr_p[r0, t1i]
           + wr * (1 - wt) * snr_p[r0 + 1, t0i]
           + wr * wt * snr_p[r0 + 1, t1i])
    valid = (rr >= fwhm / 2.0 + 1.0) & (rr <= n_r - 1)
    return torch.where(valid, out, 0.0)

"""Automatic point-source detection in post-processed frames (port of
``vip_tpu.metrics.detection``).

Peak finding, LoG/DoG blob detection and the per-blob 2-d Gaussian
vetting are host numpy and scipy, as in vip_tpu (skimage-equivalent
semantics); the S/N filter runs through the port's batched photometry
(``metrics.snr_source.snr_multi``) on the frame's device. pandas is
imported only for the table that ``full_output=True`` returns, and
matplotlib only when ``plot=True``.
"""

import numpy as np
import torch
from scipy.ndimage import (correlate, gaussian_filter, gaussian_laplace,
                           maximum_filter)

from ..config.utils_conf import sep
from ..var.coords import frame_center
from ..var.fit_2d import (GAUSSIAN_FWHM_TO_SIGMA, GAUSSIAN_SIGMA_TO_FWHM,
                          fit_2dgaussian, gaussian_2d)
from ..var.filters import frame_filter_lowpass
from ..var.shapes import get_square, mask_circle
from .snr_source import frame_report, snr_multi, snrmap

__all__ = ["detection", "peak_coordinates", "mask_source_centers",
           "mask_sources"]


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def peak_local_max(image, threshold_abs=None, min_distance=1, num_peaks=None):
    """Local maxima with a minimum separation (skimage-equivalent; vip_tpu
    detection.py:25)."""
    size = 2 * min_distance + 1
    image_max = maximum_filter(image, size=size, mode="constant")
    mask = image == image_max
    if threshold_abs is not None:
        mask &= image > threshold_abs
    coords = np.column_stack(np.nonzero(mask))
    values = image[tuple(coords.T)] if len(coords) else np.array([])
    order = np.argsort(values)[::-1]
    coords = coords[order]
    accepted = []
    for c in coords:
        if all(np.hypot(c[0] - a[0], c[1] - a[1]) >= min_distance
               for a in accepted):
            accepted.append(c)
        if num_peaks is not None and len(accepted) >= num_peaks:
            break
    return np.array(accepted, dtype=int).reshape(-1, 2)


def _blob_multiscale(image, threshold, min_sigma, max_sigma, mode="log",
                     n_scales=5):
    """LoG / DoG blob detection (skimage-equivalent semantics)."""
    sigmas = np.linspace(min_sigma, max_sigma, n_scales)
    if mode == "log":
        stack = np.stack([-gaussian_laplace(image, s) * s ** 2
                          for s in sigmas])
    else:
        gs = [gaussian_filter(image, s) for s in sigmas]
        stack = np.stack([(gs[i] - gs[i + 1]) * sigmas[i]
                          for i in range(n_scales - 1)])
        sigmas = sigmas[:-1]
    peaks = []
    for k in range(stack.shape[0]):
        coords = peak_local_max(stack[k], threshold_abs=threshold,
                                min_distance=max(1, int(min_sigma)))
        for c in coords:
            peaks.append((c[0], c[1], sigmas[k]))
    if not peaks:
        return np.zeros((0, 3))
    return np.array(peaks)


def _sigma_clipped_stats(data, sigma=5, maxiters=None):
    d = np.asarray(data, dtype=float).ravel()
    d = d[np.isfinite(d)]
    for _ in range(maxiters or 10):
        med = np.median(d)
        std = np.std(d)
        keep = np.abs(d - med) <= sigma * std
        if keep.all():
            break
        d = d[keep]
    return np.mean(d), np.median(d), np.std(d)


def _check_blobs(arr, coords_temp, fwhm, debug, pad, mode):
    """Keep the blobs whose direct Gaussian2D least-squares fit (started
    at the subimage center, amplitude = max, stddev from the expected
    FWHM; vip_tpu detection.py:94) is positive, centered within 2 px and
    of a FWHM within 3 px of ``fwhm``."""
    from scipy.optimize import least_squares

    coords = []
    for y, x in coords_temp:
        subsi = 3 * int(np.ceil(fwhm))
        if subsi % 2 == 0:
            subsi += 1
        if mode in ("lpeaks", "log", "dog"):
            scy, scx = y + pad, x + pad
        else:
            scy, scx = y, x
        try:
            subim, suby, subx = get_square(arr, subsi, scy, scx,
                                           position=True, force=True,
                                           verbose=False)
        except RuntimeError:
            continue
        cy, cx = frame_center(subim)
        sig = fwhm * GAUSSIAN_FWHM_TO_SIGMA
        p0 = np.array([subim.max(), cx, cy, sig, sig, 0.0])
        sy, sx = np.indices(subim.shape)
        xr, yr, data = sx.ravel(), sy.ravel(), subim.ravel()

        def resid(p):
            return gaussian_2d(xr, yr, *p) - data

        try:
            res = least_squares(resid, p0, method="lm", max_nfev=5000)
        except Exception:
            res = least_squares(resid, p0, max_nfev=5000)
        amplitude, fit_x, fit_y, x_stddev, y_stddev, _ = res.x
        fwhm_y = y_stddev * GAUSSIAN_SIGMA_TO_FWHM
        fwhm_x = x_stddev * GAUSSIAN_SIGMA_TO_FWHM
        mean_fwhm_fit = np.mean([abs(fwhm_x), abs(fwhm_y)])
        condyf = np.allclose(fit_y, cy, atol=2)
        condxf = np.allclose(fit_x, cx, atol=2)
        condmf = np.allclose(mean_fwhm_fit, fwhm, atol=3)
        if amplitude > 0 and condxf and condyf and condmf:
            coords.append((suby + fit_y, subx + fit_x))
            if debug:
                print(f"Coordinates (Y,X): {y:.3f},{x:.3f}")
                print(f"fit peak = {amplitude:.3f}")
                print(f"fwhm_y in px = {fwhm_y:.3f}, fwhm_x in px = "
                      f"{fwhm_x:.3f}")
                print(f"mean fit fwhm = {mean_fwhm_fit:.3f}")
    return coords


def detection(array, fwhm=4, psf=None, mode="lpeaks", bkg_sigma=5,
              matched_filter=False, mask=True, snr_thresh=5, nproc=1,
              plot=True, debug=False, full_output=False, verbose=True,
              **kwargs):
    """Find point-like sources (vip_tpu detection.py:85): candidate peaks
    ('lpeaks', 'log', 'dog'; or peaks of the S/N map, 'snrmap' and
    'snrmapf'), vetted by a 2-d Gaussian fit and the S/N threshold.
    Returns host (yy, xx) arrays of the sources, (0, 0) when none, or a
    pandas table with their S/N when ``full_output``."""
    array = np.asarray(_host(array), dtype=float)
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array")
    if psf is not None:
        psf = _host(psf)
        if psf.ndim != 2 and psf.shape[0] < array.shape[0]:
            raise TypeError("Input psf is not a 2d array or has wrong size")
    elif matched_filter:
        raise ValueError("`psf` must be provided when `matched_filter` is "
                         "True")

    if fwhm is None:
        if psf is None:
            raise ValueError("`fwhm` or `psf` must be provided")
        outdf = fit_2dgaussian(psf, cent=frame_center(psf), debug=debug,
                               full_output=True)
        fwhm = float(np.mean([outdf["fwhm_x"], outdf["fwhm_y"]]))
        if verbose:
            print(f"FWHM = {fwhm:.2f} pxs\n")

    if mask:
        array = mask_circle(torch.from_numpy(array), radius=fwhm).numpy()

    if mode in ("lpeaks", "log", "dog"):
        frame_det = correlate(array, psf) if matched_filter else array
        _, median, stddev = _sigma_clipped_stats(frame_det, sigma=5)
        bkg_level = median + (stddev * bkg_sigma)
        if debug:
            print(f"Sigma clipped median = {median:.3f}")
            print(f"Sigma clipped stddev = {stddev:.3f}")
            print(f"Background threshold = {bkg_level:.3f}", "\n")
        pad = 10
        array_padded = np.pad(array, pad, "constant", constant_values=0)
    elif mode in ("snrmap", "snrmapf"):
        frame_det = _host(snrmap(array, fwhm=fwhm,
                                 approximated=mode == "snrmapf", plot=False,
                                 nproc=nproc, verbose=verbose))
        pad = 0
    else:
        raise ValueError("`mode` not recognized")

    if mode in ("lpeaks", "snrmap", "snrmapf"):
        threshold = bkg_level if mode == "lpeaks" else snr_thresh
        coords_temp = peak_local_max(frame_det, threshold_abs=threshold,
                                     min_distance=int(np.ceil(fwhm)),
                                     num_peaks=20)
        arr_check = array_padded if mode == "lpeaks" else array
        coords = np.array(_check_blobs(arr_check, coords_temp, fwhm, debug,
                                       pad, mode))
    else:
        sigma = fwhm * GAUSSIAN_FWHM_TO_SIGMA
        blobs = _blob_multiscale(frame_det.astype(float), bkg_level,
                                 sigma - 0.5, sigma + 0.5, mode=mode)
        if len(blobs) == 0:
            if verbose:
                print(sep)
                print("No potential sources found")
                print(sep)
            return (None, None) if full_output else (0, 0)
        coords = np.array(_check_blobs(array_padded,
                                       blobs[:, :2].astype(int), fwhm,
                                       debug, pad, mode))

    if coords.shape[0] == 0:
        if verbose:
            print(sep)
            print("No potential sources found")
            print(sep)
        return (None, None) if full_output else (0, 0)

    yy = coords[:, 0]
    xx = coords[:, 1]
    if mode in ("lpeaks", "log", "dog"):
        yy = yy - pad
        xx = xx - pad

    yy_final, xx_final, snr_final = [], [], []
    # every candidate's S/N from one batched photometry call
    snr_values, _ = snr_multi(array, xx, yy, fwhm)
    for i in range(yy.shape[0]):
        y, x = yy[i], xx[i]
        if verbose:
            print("")
            print(sep)
            print(f"X,Y = ({x:.1f},{y:.1f})")
        snr_value = float(snr_values[i])
        if snr_value >= snr_thresh:
            if verbose:
                frame_report(array, fwhm, (x, y), verbose=verbose)
            yy_final.append(y)
            xx_final.append(x)
            snr_final.append(snr_value)
        elif verbose:
            print(f"S/N constraint NOT fulfilled (S/N = {snr_value:.3f})")
    if verbose:
        print(sep)

    yy_final = np.array(yy_final)
    xx_final = np.array(xx_final)

    if plot:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.imshow(array, origin="lower")
        for x, y in zip(xx_final, yy_final):
            plt.gca().add_patch(plt.Circle((x, y), radius=fwhm, color="r",
                                           fill=False))
        if kwargs.get("plot_title") is not None:
            plt.title(kwargs["plot_title"])
        if kwargs.get("save_plot") is not None:
            plt.savefig(kwargs["save_plot"], dpi=100, bbox_inches="tight")
        plt.show()

    if full_output:
        import pandas as pn

        return pn.DataFrame({"y": yy_final.tolist(), "x": xx_final.tolist(),
                             "px_snr": snr_final})
    return yy_final, xx_final


def peak_coordinates(obj_tmp, fwhm, approx_peak=None, search_box=None,
                     channels_peak=False):
    """Coordinates of the brightest pixel after a median filter of size
    fwhm (vip_tpu detection.py:274), of a frame or of each channel of a
    cube; host ints."""
    obj_tmp = _host(obj_tmp)
    ndims = obj_tmp.ndim

    def medfilt(frame, size):
        return _host(frame_filter_lowpass(torch.from_numpy(
            np.ascontiguousarray(frame)), "median", median_size=int(size)))

    sbox_y = sbox_x = None
    if approx_peak is not None:
        if np.isscalar(search_box):
            sbox_y = sbox_x = search_box
        elif len(search_box) == 2:
            sbox_y, sbox_x = search_box
        else:
            raise ValueError("The search box does not have the right number "
                             "of elements")

    if ndims == 2:
        med_filt_tmp = medfilt(obj_tmp, fwhm)
        if approx_peak is None:
            return np.unravel_index(np.nanargmax(med_filt_tmp),
                                    med_filt_tmp.shape)
        sbox = med_filt_tmp[approx_peak[0] - sbox_y:
                            approx_peak[0] + sbox_y + 1,
                            approx_peak[1] - sbox_x:
                            approx_peak[1] + sbox_x + 1]
        ind_max_sbox = np.unravel_index(np.nanargmax(sbox), sbox.shape)
        return (approx_peak[0] - sbox_y + ind_max_sbox[0],
                approx_peak[1] - sbox_x + ind_max_sbox[1])

    if ndims == 3:
        n_z = obj_tmp.shape[0]
        med_filt_tmp = np.zeros_like(obj_tmp)
        ind_ch_max = np.zeros([n_z, 2])
        if np.isscalar(fwhm):
            fwhm = [fwhm] * n_z
        sbox = None
        if approx_peak is not None:
            sbox = np.zeros([n_z, 2 * sbox_y + 1, 2 * sbox_x + 1])
        for zz in range(n_z):
            med_filt_tmp[zz] = medfilt(obj_tmp[zz], fwhm[zz])
            if approx_peak is None:
                ind_ch_max[zz] = np.unravel_index(
                    np.nanargmax(med_filt_tmp[zz]), med_filt_tmp[zz].shape)
            else:
                sbox[zz] = med_filt_tmp[zz,
                                        approx_peak[0] - sbox_y:
                                        approx_peak[0] + sbox_y + 1,
                                        approx_peak[1] - sbox_x:
                                        approx_peak[1] + sbox_x + 1]
                ind_max_sbox = np.unravel_index(np.nanargmax(sbox[zz]),
                                                sbox[zz].shape)
                ind_ch_max[zz] = (approx_peak[0] - sbox_y + ind_max_sbox[0],
                                  approx_peak[1] - sbox_x + ind_max_sbox[1])
        if approx_peak is None:
            ind_max = np.unravel_index(np.nanargmax(med_filt_tmp),
                                       med_filt_tmp.shape)
        else:
            # the (y, x) components of the 3-d unravel, as vip_tpu
            ind_max_tmp = np.unravel_index(np.nanargmax(sbox), sbox.shape)
            ind_max = (ind_max_tmp[1] + approx_peak[0] - sbox_y,
                       ind_max_tmp[2] + approx_peak[1] - sbox_x)
        if channels_peak:
            return ind_max, ind_ch_max
        return ind_max


def mask_source_centers(array, fwhm, y=None, x=None):
    """Ones mask with zeros at the source centers, found by LoG detection
    unless given (vip_tpu detection.py:346). Host numpy."""
    array = _host(array)
    if array.ndim != 2:
        raise TypeError("Wrong input array shape.")
    if y is None or x is None:
        frame = mask_circle(torch.from_numpy(np.array(array, dtype=float)),
                            radius=2 * fwhm).numpy()
        yy, xx = detection(frame, fwhm, plot=False, mode="log",
                           verbose=False)
    else:
        yy = np.array(y)
        xx = np.array(x)
    mask = np.ones_like(array)
    if np.isscalar(yy):
        yy, xx = np.array([yy]), np.array([xx])
    mask[np.asarray(yy).astype(int), np.asarray(xx).astype(int)] = 0
    return mask


def mask_sources(mask, ap_rad):
    """Grow each zero of ``mask`` into a zeroed aperture of radius
    ``ap_rad`` (vip_tpu detection.py:364). Host numpy."""
    mask = _host(mask)
    mask_out = mask.copy()
    zeros_y, zeros_x = np.where(mask == 0)
    yy, xx = np.mgrid[: mask.shape[0], : mask.shape[1]]
    for y0, x0 in zip(zeros_y, zeros_x):
        mask_out[(yy - y0) ** 2 + (xx - x0) ** 2 <= ap_rad ** 2] = 0
    return mask_out

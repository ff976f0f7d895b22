"""2-d Gaussian, Moffat and Airy models and fits (port of
``vip_tpu.var.fit_2d``).

Host numpy and scipy, as in vip_tpu: the models match astropy's
Gaussian2D, Moffat2D and AiryDisk2D, the fits are Levenberg-Marquardt
through ``scipy.optimize.least_squares`` with vip_tpu's initialization
(center-of-mass centroid, peak-to-peak amplitude). The double Gaussian
and ``create_synth_psf`` wait for ROADMAP Queue 1, slice 8.
"""

import numpy as np
from scipy.optimize import least_squares
from scipy.special import j1

from ..config.utils_conf import check_array
from .coords import frame_center
from .shapes import get_square

GAUSSIAN_FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))
GAUSSIAN_SIGMA_TO_FWHM = 2.0 * np.sqrt(2.0 * np.log(2.0))

__all__ = ["fit_2dgaussian", "fit_2dmoffat", "fit_2dairydisk",
           "gaussian_2d", "moffat_2d", "airydisk_2d",
           "GAUSSIAN_FWHM_TO_SIGMA", "GAUSSIAN_SIGMA_TO_FWHM"]


def gaussian_2d(x, y, amplitude, x_mean, y_mean, x_stddev, y_stddev, theta):
    """astropy Gaussian2D: theta in radians, counter-clockwise from +x."""
    cost2 = np.cos(theta) ** 2
    sint2 = np.sin(theta) ** 2
    sin2t = np.sin(2 * theta)
    xstd2 = x_stddev ** 2
    ystd2 = y_stddev ** 2
    a = 0.5 * (cost2 / xstd2 + sint2 / ystd2)
    b = 0.5 * (sin2t / xstd2 - sin2t / ystd2)
    c = 0.5 * (sint2 / xstd2 + cost2 / ystd2)
    xd = x - x_mean
    yd = y - y_mean
    return amplitude * np.exp(-(a * xd ** 2 + b * xd * yd + c * yd ** 2))


def moffat_2d(x, y, amplitude, x_0, y_0, gamma, alpha):
    """astropy Moffat2D (vip_tpu fit_2d.py:43)."""
    rr_gg = ((x - x_0) ** 2 + (y - y_0) ** 2) / gamma ** 2
    return amplitude * (1 + rr_gg) ** (-alpha)


def airydisk_2d(x, y, amplitude, x_0, y_0, radius):
    """astropy AiryDisk2D, its first zero at ``radius`` (vip_tpu
    fit_2d.py:49)."""
    rz = 1.2196698912665045  # first zero of j1(pi x)/x, over pi
    r = np.hypot(x - x_0, y - y_0) / (radius / rz)
    out = np.ones_like(r)
    mask = r > 0
    rt = np.pi * r[mask]
    out[mask] = (2.0 * j1(rt) / rt) ** 2
    return amplitude * out


def _centroid_com(data):
    d = np.asarray(data, dtype=float)
    total = d.sum()
    yy, xx = np.mgrid[: d.shape[0], : d.shape[1]]
    return (d * xx).sum() / total, (d * yy).sum() / total


def _threshold_noise(subim, sigfactor):
    """Replace the pixels below median + sigfactor·std (2-sigma-clipped
    statistics) by Gaussian noise of that std (vip_tpu fit_2d.py:109)."""
    from numpy.random import randn

    d = subim.ravel()
    d = d[np.isfinite(d)]
    for _ in range(5):
        keep = np.abs(d - np.median(d)) <= 2 * np.std(d, ddof=0)
        if keep.all():
            break
        d = d[keep]
    clipmed, clipstd = np.median(d), np.std(d)
    indi = np.where(subim <= clipmed + sigfactor * clipstd)
    noise = randn(*subim.shape) * clipstd
    out = subim.copy()
    out[indi] = noise[indi]
    return out


def _lm_fit(residual_fn, p0):
    try:
        res = least_squares(residual_fn, p0, method="lm", max_nfev=5000)
    except Exception:
        res = least_squares(residual_fn, p0, max_nfev=5000)
    try:
        _, s, VT = np.linalg.svd(res.jac, full_matrices=False)
        thr = np.finfo(float).eps * max(res.jac.shape) * s[0]
        s = s[s > thr]
        VT = VT[: s.size]
        dof = max(res.fun.size - res.x.size, 1)
        cov = np.dot(VT.T / s ** 2, VT) * 2 * res.cost / dof
        perr = np.sqrt(np.diag(cov))
    except Exception:
        perr = np.full_like(res.x, np.nan)
    return res.x, perr


def _host(array):
    return array.cpu().numpy() if hasattr(array, "cpu") else array


def _prepare_subimage(array, crop, cent, cropsize, bpm):
    array = np.asarray(_host(array), dtype=float)
    if bpm is None:
        bpm = np.zeros_like(array).astype(bool)
    if crop:
        if cent is None:
            ceny, cenx = frame_center(array)
        else:
            cenx, ceny = cent
        imside = array.shape[0]
        psf_subimage, suby, subx = get_square(array, min(cropsize, imside),
                                              ceny, cenx, position=True,
                                              verbose=False)
        bpm_subimage, _, _ = get_square(bpm, min(cropsize, imside), ceny,
                                        cenx, position=True, verbose=False)
    else:
        psf_subimage = array.copy()
        bpm_subimage = bpm.copy()
        suby = subx = 0
    return psf_subimage, bpm_subimage, suby, subx


def _fit_data(array, crop, cent, cropsize, threshold, sigfactor, bpm):
    """The sub-image of a fit, its good pixels' coordinates and values,
    the initial amplitude and centroid, and the sub-image's corner."""
    check_array(array, dim=2, msg="array")
    psf_subimage, bpm_subimage, suby, subx = _prepare_subimage(
        array, crop, cent, cropsize, bpm)
    if threshold:
        psf_subimage = _threshold_noise(psf_subimage, sigfactor)
    good = ~bpm_subimage
    init_amplitude = np.ptp(psf_subimage[good])
    xcom, ycom = _centroid_com(psf_subimage)
    y, x = np.indices(psf_subimage.shape)
    return (x[good], y[good], psf_subimage[good], init_amplitude, xcom, ycom,
            suby, subx)


def _gaussian_fit(array, crop=False, cent=None, cropsize=15, fwhmx=4,
                  fwhmy=4, theta=0, threshold=False, sigfactor=6, bpm=None,
                  debug=True):
    """The 2-d Gaussian fit of :func:`fit_2dgaussian` as a dict of its
    table's columns (floats), without pandas."""
    xg, yg, data, init_amplitude, xcom, ycom, suby, subx = _fit_data(
        array, crop, cent, cropsize, threshold, sigfactor, bpm)
    p0 = np.array([init_amplitude, xcom, ycom,
                   fwhmx * GAUSSIAN_FWHM_TO_SIGMA,
                   fwhmy * GAUSSIAN_FWHM_TO_SIGMA, theta])

    def resid(p):
        return gaussian_2d(xg, yg, *p) - data

    p, perr = _lm_fit(resid, p0)
    amplitude, mean_x, mean_y, xstd, ystd, th = p
    mean_y_tot = mean_y + suby
    mean_x_tot = mean_x + subx
    fwhm_y = abs(ystd) * GAUSSIAN_SIGMA_TO_FWHM
    fwhm_x = abs(xstd) * GAUSSIAN_SIGMA_TO_FWHM
    theta_deg = np.rad2deg(th)
    amplitude_e, mean_x_e, mean_y_e, fwhm_x_e, fwhm_y_e, theta_e = perr
    fwhm_x_e /= GAUSSIAN_FWHM_TO_SIGMA
    fwhm_y_e /= GAUSSIAN_FWHM_TO_SIGMA
    if debug:
        print("FWHM_y =", fwhm_y)
        print("FWHM_x =", fwhm_x)
        print("centroid y =", mean_y_tot)
        print("centroid x =", mean_x_tot)
        print("amplitude =", amplitude)
        print("theta =", theta_deg)
    return {"centroid_y": mean_y_tot, "centroid_x": mean_x_tot,
            "fwhm_y": fwhm_y, "fwhm_x": fwhm_x, "amplitude": amplitude,
            "theta": theta_deg, "centroid_y_err": mean_y_e,
            "centroid_x_err": mean_x_e, "fwhm_y_err": fwhm_y_e,
            "fwhm_x_err": fwhm_x_e, "amplitude_err": amplitude_e,
            "theta_err": theta_e}


def fit_2dgaussian(array, crop=False, cent=None, cropsize=15, fwhmx=4,
                   fwhmy=4, theta=0, threshold=False, sigfactor=6, bpm=None,
                   full_output=True, debug=True):
    """Fit a 2-d Gaussian to a frame (vip_tpu fit_2d.py:171). Returns a
    one-row pandas table with ``full_output`` (pandas is imported only
    then), else the (y, x) centroid."""
    fit = _gaussian_fit(array, crop, cent, cropsize, fwhmx, fwhmy, theta,
                        threshold, sigfactor, bpm, debug)
    if full_output:
        import pandas as pd

        return pd.DataFrame(fit, index=[0], dtype=np.float64)
    return fit["centroid_y"], fit["centroid_x"]


def _moffat_fit(array, crop=False, cent=None, cropsize=15, fwhm=4,
                threshold=False, sigfactor=6, bpm=None, debug=True):
    """The 2-d Moffat fit of :func:`fit_2dmoffat` as a dict of its table's
    columns (floats), without pandas."""
    xg, yg, data, init_amplitude, xcom, ycom, suby, subx = _fit_data(
        array, crop, cent, cropsize, threshold, sigfactor, bpm)
    alpha0 = 1.5
    gamma0 = fwhm / (2.0 * np.sqrt(2 ** (1 / alpha0) - 1))
    p0 = np.array([init_amplitude, xcom, ycom, gamma0, alpha0])

    def resid(p):
        return moffat_2d(xg, yg, *p) - data

    p, perr = _lm_fit(resid, p0)
    amplitude, mean_x, mean_y, gamma, alpha = p
    mean_y_tot = mean_y + suby
    mean_x_tot = mean_x + subx
    fwhm_fit = np.abs(2 * gamma * np.sqrt(2 ** (1 / alpha) - 1))
    if debug:
        print("FWHM =", fwhm_fit)
        print("centroid y =", mean_y_tot)
        print("centroid x =", mean_x_tot)
    return {"centroid_y": mean_y_tot, "centroid_x": mean_x_tot,
            "fwhm": fwhm_fit, "alpha": alpha, "gamma": gamma,
            "amplitude": amplitude, "centroid_y_err": perr[2],
            "centroid_x_err": perr[1], "gamma_err": perr[3],
            "alpha_err": perr[4], "amplitude_err": perr[0]}


def _airy_fit(array, crop=False, cent=None, cropsize=15, fwhm=4,
              threshold=False, sigfactor=6, bpm=None, debug=True):
    """The 2-d Airy fit of :func:`fit_2dairydisk` as a dict of its table's
    columns (floats), without pandas."""
    xg, yg, data, init_amplitude, xcom, ycom, suby, subx = _fit_data(
        array, crop, cent, cropsize, threshold, sigfactor, bpm)
    diam_1st_zero = (fwhm * 2.44) / 1.028
    p0 = np.array([init_amplitude, xcom, ycom, diam_1st_zero / 2.0])

    def resid(p):
        return airydisk_2d(xg, yg, *p) - data

    p, perr = _lm_fit(resid, p0)
    amplitude, mean_x, mean_y, radius = p
    mean_y_tot = mean_y + suby
    mean_x_tot = mean_x + subx
    fwhm_fit = radius * 1.028 / 1.22
    if debug:
        print("FWHM =", fwhm_fit)
        print("centroid y =", mean_y_tot)
        print("centroid x =", mean_x_tot)
    return {"centroid_y": mean_y_tot, "centroid_x": mean_x_tot,
            "fwhm": fwhm_fit, "radius": radius, "amplitude": amplitude,
            "centroid_y_err": perr[2], "centroid_x_err": perr[1],
            "radius_err": perr[3], "amplitude_err": perr[0]}


def fit_2dmoffat(array, crop=False, cent=None, cropsize=15, fwhm=4,
                 threshold=False, sigfactor=6, bpm=None, full_output=True,
                 debug=True):
    """Fit a 2-d Moffat to a frame (vip_tpu fit_2d.py:227). Returns a
    one-row pandas table with ``full_output`` (pandas is imported only
    then), else the (y, x) centroid."""
    fit = _moffat_fit(array, crop, cent, cropsize, fwhm, threshold,
                      sigfactor, bpm, debug)
    if full_output:
        import pandas as pd

        return pd.DataFrame(fit, index=[0], dtype=np.float64)
    return fit["centroid_y"], fit["centroid_x"]


def fit_2dairydisk(array, crop=False, cent=None, cropsize=15, fwhm=4,
                   threshold=False, sigfactor=6, bpm=None, full_output=True,
                   debug=True):
    """Fit a 2-d Airy disk to a frame (vip_tpu fit_2d.py:274). Returns a
    one-row pandas table with ``full_output`` (pandas is imported only
    then), else the (y, x) centroid."""
    fit = _airy_fit(array, crop, cent, cropsize, fwhm, threshold, sigfactor,
                    bpm, debug)
    if full_output:
        import pandas as pd

        return pd.DataFrame(fit, index=[0], dtype=np.float64)
    return fit["centroid_y"], fit["centroid_x"]

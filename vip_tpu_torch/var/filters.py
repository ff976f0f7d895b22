"""Frame filtering: the low-pass filters the metrics use (port of part of
``vip_tpu.var.filters``).

Convolutions follow the astropy.convolution semantics VIP relies on
(normalized kernel, zero-fill boundary, NaN interpolation by the
convolved valid-coverage map) as FFT convolutions on the image's device.
Only what the S/N and detection path calls is ported: the Gaussian
kernel, ``convolve_with_mask`` and the 'gauss', 'psf' and 'median' modes
of ``frame_filter_lowpass``; the high-pass filters, the cube filters,
IUWT and deconvolution wait for ROADMAP Queue 1, slice 8.
"""

import numpy as np
import torch

from ..config.device import as_tensor

GAUSSIAN_FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))

__all__ = ["frame_filter_lowpass", "cube_filter_lowpass", "gaussian_kernel_2d",
           "convolve_with_mask"]


def _round_up_to_odd_integer(value):
    i = int(np.ceil(value))
    return i + 1 if i % 2 == 0 else i


def gaussian_kernel_2d(sigma_x, sigma_y=None, x_size=None, y_size=None):
    """Sampled, normalized 2-d Gaussian kernel, host float64 (astropy
    Gaussian2DKernel semantics: default support 8·stddev rounded up to
    odd; vip_tpu filters.py:49)."""
    if sigma_y is None:
        sigma_y = sigma_x
    if x_size is None:
        x_size = _round_up_to_odd_integer(8 * max(sigma_x, 1e-3))
    if y_size is None:
        y_size = _round_up_to_odd_integer(8 * max(sigma_y, 1e-3))
    xs = np.arange(x_size) - (x_size - 1) / 2
    ys = np.arange(y_size) - (y_size - 1) / 2
    gx = np.exp(-0.5 * (xs / sigma_x) ** 2)
    gy = np.exp(-0.5 * (ys / sigma_y) ** 2)
    k = np.outer(gy, gx)
    return k / k.sum()


def _fft_convolve_same(image, kernel):
    """'same'-size linear FFT convolution with a zero-fill boundary."""
    iy, ix = image.shape
    ky, kx = kernel.shape
    fy, fx = iy + ky - 1, ix + kx - 1
    F = torch.fft.rfft2(image, s=(fy, fx))
    G = torch.fft.rfft2(kernel, s=(fy, fx))
    full = torch.fft.irfft2(F * G, s=(fy, fx))
    y0 = (ky - 1) // 2
    x0 = (kx - 1) // 2
    return full[y0:y0 + iy, x0:x0 + ix]


def convolve_with_mask(image, kernel, interpolate_nan=True):
    """astropy-style convolution (vip_tpu filters.py:80): NaNs and the
    boundary are handled by dividing by the convolved valid-coverage map.
    Returns a tensor on the image's device."""
    image = as_tensor(image)
    kernel = as_tensor(kernel, image.device, image.dtype)
    finite = torch.isfinite(image)
    num = _fft_convolve_same(torch.where(finite, image, 0.0), kernel)
    if interpolate_nan:
        return num / _fft_convolve_same(finite.to(image.dtype), kernel)
    return num


def _interp_remaining_nan(filtered, kernel):
    """Fill the NaNs that survive the masked convolution with the kernel
    interpolation of the valid filtered values (vip_tpu filters.py:160)."""
    conv = convolve_with_mask(filtered, kernel)
    return torch.where(torch.isnan(filtered), conv, filtered)


def frame_filter_lowpass(array, mode="gauss", median_size=5, fwhm_size=5,
                         conv_mode="convfft", kernel_sz=None, psf=None,
                         mask=None, iterate=True, half_res_y=False, **kwargs):
    """Low-pass filter a frame: 'median' (scipy's median filter on the
    host), 'gauss' or 'psf' convolution (vip_tpu filters.py:96). Returns a
    tensor on the frame's device."""
    array = as_tensor(array)
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array.")
    if not isinstance(median_size, int):
        raise ValueError("`Median_size` must be integer")

    if mode == "median":
        from scipy.ndimage import median_filter

        out = median_filter(array.cpu().numpy(), median_size, mode="nearest")
        return torch.as_tensor(out, device=array.device)
    if mode == "gauss":
        kernel_sz_y = kernel_sz
        if np.isscalar(fwhm_size):
            sigma = fwhm_size * GAUSSIAN_FWHM_TO_SIGMA
            sigma_y = sigma
        else:
            if len(fwhm_size) != 2:
                raise TypeError("If not a scalar, fwhm_size must be of "
                                "length 2")
            sigma_y = fwhm_size[0] * GAUSSIAN_FWHM_TO_SIGMA
            sigma = fwhm_size[1] * GAUSSIAN_FWHM_TO_SIGMA
            if kernel_sz is not None:
                kernel_sz_y = int(kernel_sz * fwhm_size[0] / fwhm_size[1])
                if kernel_sz_y % 2 != kernel_sz % 2:
                    kernel_sz_y += 1
        if half_res_y:
            sigma_y = max(1, sigma_y // 2)
            if kernel_sz_y is not None:
                kernel_sz_y = kernel_sz_y // 2
                if kernel_sz_y % 2 != kernel_sz % 2:
                    kernel_sz_y += 1
        kernel = gaussian_kernel_2d(sigma, sigma_y, x_size=kernel_sz,
                                    y_size=kernel_sz_y)
    elif mode == "psf":
        if psf is None:
            raise TypeError("psf should be provided for convolution")
        if psf.ndim != 2:
            raise TypeError("Input psf is not a frame or 2d array.")
        if psf.shape[-1] > array.shape[-1]:
            raise TypeError("Input psf is larger than input array. Crop.")
        kernel = psf
    else:
        raise TypeError("Low-pass filter mode not recognized")
    work = array
    if mask is not None:
        mask = as_tensor(np.asarray(mask).astype(bool), array.device,
                         torch.bool)
        work = array.masked_fill(mask, torch.nan)
    filtered = convolve_with_mask(work, kernel)
    if iterate and bool(torch.isnan(filtered).any()):
        filtered = _interp_remaining_nan(filtered, kernel)
    return filtered


def cube_filter_lowpass(array, mode="gauss", median_size=5, fwhm_size=5,
                        conv_mode="conv", kernel_sz=None, verbose=True,
                        psf=None, mask=None, iterate=True, half_res_y=False,
                        nproc=1, **kwargs):
    """:func:`frame_filter_lowpass` of every frame of a cube (vip_tpu
    filters.py:267). Returns a tensor on the cube's device."""
    array = as_tensor(array)
    return torch.stack([
        frame_filter_lowpass(array[i], mode, median_size, fwhm_size,
                             conv_mode, kernel_sz, psf, mask, iterate,
                             half_res_y, **kwargs)
        for i in range(array.shape[0])])

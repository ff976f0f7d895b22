"""Frame and cube filtering: the low-pass and high-pass filters (port of
``vip_tpu.var.filters``).

Convolutions follow the astropy.convolution semantics VIP relies on
(normalized kernel, zero-fill boundary, NaN interpolation by the
convolved valid-coverage map) as FFT convolutions on the image's device.
Every filter works on the last two axes of a tensor, so a cube is
filtered in one batched pass on its device; only the 'median' modes run
frame by frame, through scipy's median filter on the host, as in
vip_tpu. The 'laplacian' high-pass mode computes OpenCV's ``Laplacian``
itself (the aperture kernel of ``ksize``, ``BORDER_REFLECT_101``, a
float32 result). IUWT and deconvolution wait for ROADMAP Queue 1,
slice 8.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..config.device import as_tensor, get_device

GAUSSIAN_FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))

__all__ = ["frame_filter_lowpass", "cube_filter_lowpass",
           "frame_filter_highpass", "cube_filter_highpass",
           "gaussian_kernel_2d", "convolve_with_mask", "fft", "ifft"]

# the kernels of the 'laplacian-conv' mode (vip_tpu filters.py:204-217)
_LAPLACIAN_CONV = {
    3: [[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]],
    5: [[-4, -1, 0, -1, -4], [-1, 2, 3, 2, -1], [0, 3, 4, 3, 0],
        [-1, 2, 3, 2, -1], [-4, -1, 0, -1, -4]],
    7: [[-10, -5, -2, -1, -2, -5, -10], [-5, 0, 3, 4, 3, 0, -5],
        [-2, 3, 6, 7, 6, 3, -2], [-1, 4, 7, 8, 7, 4, -1],
        [-2, 3, 6, 7, 6, 3, -2], [-5, 0, 3, 4, 3, 0, -5],
        [-10, -5, -2, -1, -2, -5, -10]],
}


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
    """'same'-size linear FFT convolution of the last two axes with a
    zero-fill boundary."""
    iy, ix = image.shape[-2:]
    ky, kx = kernel.shape
    fy, fx = iy + ky - 1, ix + kx - 1
    F_ = torch.fft.rfft2(image, s=(fy, fx))
    G = torch.fft.rfft2(kernel, s=(fy, fx))
    full = torch.fft.irfft2(F_ * G, s=(fy, fx))
    y0 = (ky - 1) // 2
    x0 = (kx - 1) // 2
    return full[..., y0:y0 + iy, x0:x0 + ix]


def convolve_with_mask(image, kernel, interpolate_nan=True):
    """astropy-style convolution of a frame or of every frame of a cube
    (vip_tpu filters.py:80): NaNs and the boundary are handled by dividing
    by the convolved valid-coverage map. Returns a tensor on the image's
    device."""
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


def _median_frames(array, median_size):
    """scipy's median filter (mode 'nearest') of each frame, on the host;
    a tensor on the array's device."""
    from scipy.ndimage import median_filter

    host = array.cpu().numpy()
    size = (1,) * (host.ndim - 2) + (median_size, median_size)
    return torch.as_tensor(median_filter(host, size, mode="nearest"),
                           device=array.device)


def _lowpass(array, mode, median_size, fwhm_size, kernel_sz, psf, mask,
             iterate, half_res_y):
    """:func:`frame_filter_lowpass` of the last two axes of a tensor."""
    if mode == "median":
        return _median_frames(array, median_size)
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
    return _lowpass(array, mode, median_size, fwhm_size, kernel_sz, psf,
                    mask, iterate, half_res_y)


def cube_filter_lowpass(array, mode="gauss", median_size=5, fwhm_size=5,
                        conv_mode="conv", kernel_sz=None, verbose=True,
                        psf=None, mask=None, iterate=True, half_res_y=False,
                        nproc=1, **kwargs):
    """:func:`frame_filter_lowpass` of every frame of a cube (vip_tpu
    filters.py:267), the convolutions in one batched pass. Returns a
    tensor on the cube's device."""
    array = as_tensor(array)
    if not isinstance(median_size, int):
        raise ValueError("`Median_size` must be integer")
    return _lowpass(array, mode, median_size, fwhm_size, kernel_sz, psf,
                    mask, iterate, half_res_y)


def fft(array):
    """Centered 2-d FFT of a frame (of the last two axes of a tensor;
    vip_tpu filters.py:32). Returns a complex tensor on the array's
    device."""
    return torch.fft.fftshift(torch.fft.fft2(as_tensor(array)),
                              dim=(-2, -1))


def ifft(array):
    """Real part of the centered 2-d inverse FFT of a frame (of the last
    two axes of a tensor; vip_tpu filters.py:38). Complex numpy input goes
    to the default device."""
    if not isinstance(array, torch.Tensor):
        array = torch.as_tensor(np.asarray(array), device=get_device())
    return torch.fft.ifft2(torch.fft.ifftshift(array, dim=(-2, -1))).real


def _butter2d_lp(size, cutoff, n=3):
    """Host low-pass 2-d Butterworth transfer function of a (rows, cols)
    frame, its radius in pixels, so that ``cutoff`` is in cycles a frame
    (vip_tpu filters.py:170, credits PsychoPy / J. Peirce)."""
    if not 0 < cutoff <= 1.0:
        raise ValueError("Cutoff frequency must be between 0 and 1.0")
    if not isinstance(n, int):
        raise ValueError("n must be an integer >= 1")
    rows, cols = size
    x = np.linspace(-0.5, 0.5, cols) * cols
    y = np.linspace(-0.5, 0.5, rows) * rows
    radius = np.sqrt((x ** 2)[np.newaxis] + (y ** 2)[:, np.newaxis])
    return 1 / (1 + (radius / cutoff) ** (2 * n))


def _sobel_1d(ksize, order):
    """OpenCV's 1-d Sobel kernel (``getSobelKernels``): the binomial
    smoothing of ``ksize - order - 1`` steps, differentiated ``order``
    times."""
    k = np.array([1.0])
    for _ in range(ksize - order - 1):
        k = np.convolve(k, [1.0, 1.0])
    for _ in range(order):
        k = np.convolve(k, [-1.0, 1.0])
    return k


def _laplacian_kernel(ksize):
    """The aperture kernel of ``cv2.Laplacian``: the 3x3 cross for
    ``ksize`` 1, ``[[2, 0, 2], [0, -8, 0], [2, 0, 2]]`` for 3, and above
    the sum of the second-derivative Sobel kernels along x and along y."""
    if ksize == 1:
        return np.array([[0.0, 1, 0], [1, -4, 1], [0, 1, 0]])
    if ksize == 3:
        return np.array([[2.0, 0, 2], [0, -8, 0], [2, 0, 2]])
    d2, s = _sobel_1d(ksize, 2), _sobel_1d(ksize, 0)
    return np.outer(s, d2) + np.outer(d2, s)


def _laplacian(array, ksize):
    """``cv2.Laplacian(-array, cv2.CV_32F, ksize=ksize)`` of the last two
    axes: the kernel of :func:`_laplacian_kernel`, ``BORDER_REFLECT_101``
    (torch's 'reflect' padding), a float32 result as OpenCV's. It is
    convolved in float64 and rounded once (OpenCV accumulates a float32
    frame in float32)."""
    if ksize % 2 == 0 or ksize < 0:
        raise ValueError("Kernel size must be an odd and positive value.")
    kernel = _laplacian_kernel(ksize)
    p = kernel.shape[0] // 2
    ny, nx = array.shape[-2:]
    flat = (-array).to(torch.float64).reshape(-1, 1, ny, nx)
    w = torch.as_tensor(kernel, dtype=torch.float64, device=array.device)
    out = F.conv2d(F.pad(flat, (p, p, p, p), mode="reflect"), w[None, None])
    return out.reshape(array.shape).to(torch.float32)


def _hann_window(npix, hann_cutoff):
    """The Hann attenuation of the central frequencies: its half-width and
    the (2 half + 1)² window 1 - hann ⊗ hann (vip_tpu filters.py:247)."""
    cutoff = npix / 2 * hann_cutoff
    inside = int(np.trunc(np.minimum(cutoff, npix / 2 - 1)
                          + np.copysign(0.5, cutoff)))
    win1d = np.hanning(2 * inside + 1)
    return inside, 1 - np.outer(win1d, win1d)


def _highpass(array, mode, median_size, kernel_size, fwhm_size, btw_cutoff,
              btw_order, hann_cutoff, psf, conv_mode, mask):
    """:func:`frame_filter_highpass` of the last two axes of a tensor."""
    if mode == "laplacian":
        return _laplacian(array, kernel_size)
    if mode == "laplacian-conv":
        if kernel_size not in _LAPLACIAN_CONV:
            raise ValueError("Kernel size must be either 3, 5 or 7.")
        kernel = torch.as_tensor(_LAPLACIAN_CONV[kernel_size],
                                 dtype=array.dtype, device=array.device)
        return _fft_convolve_same(array, kernel)
    if mode == "median-subt":
        return array - _median_frames(array, median_size)
    if mode == "gauss-subt":
        return array - _lowpass(array, "gauss", 5, fwhm_size, None, None,
                                mask, True, False)
    if mode == "fourier-butter":
        filt = 1.0 - _butter2d_lp(tuple(array.shape[-2:]), cutoff=btw_cutoff,
                                  n=btw_order)
        spectrum = fft(array)
        return ifft(spectrum * torch.as_tensor(filt, dtype=spectrum.dtype,
                                               device=array.device))
    if mode == "hann":
        npix = array.shape[-2]
        half, win = _hann_window(npix, hann_cutoff)
        spectrum = fft(array)
        box = slice(npix // 2 - half, npix // 2 + half + 1)
        spectrum[..., box, box] *= torch.as_tensor(
            win, dtype=spectrum.dtype, device=array.device)
        return ifft(spectrum)
    if mode == "psf-subt":
        return array - _lowpass(array, "psf", 5, 5, None, psf, mask, True,
                                False)
    raise TypeError("High-pass filter mode not recognized")


def frame_filter_highpass(array, mode, median_size=5, kernel_size=5,
                          fwhm_size=5, btw_cutoff=0.2, btw_order=2,
                          hann_cutoff=5, psf=None, conv_mode="conv",
                          mask=None):
    """High-pass filter a frame (vip_tpu filters.py:187): 'laplacian'
    (OpenCV's, float32 out), 'laplacian-conv', 'median-subt', 'gauss-subt',
    'fourier-butter', 'hann' or 'psf-subt'. Returns a tensor on the
    frame's device."""
    array = as_tensor(array)
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array.")
    return _highpass(array, mode, median_size, kernel_size, fwhm_size,
                     btw_cutoff, btw_order, hann_cutoff, psf, conv_mode,
                     mask)


def cube_filter_highpass(array, mode="laplacian", verbose=True, **kwargs):
    """:func:`frame_filter_highpass` of every frame of a cube (vip_tpu
    filters.py:281) in one batched pass on the cube's device (the
    'median-subt' medians frame by frame on the host). Returns a tensor."""
    array = as_tensor(array)
    opts = dict(median_size=5, kernel_size=5, fwhm_size=5, btw_cutoff=0.2,
                btw_order=2, hann_cutoff=5, psf=None, conv_mode="conv",
                mask=None)
    unknown = set(kwargs) - set(opts)
    if unknown:
        raise TypeError(f"cube_filter_highpass: unexpected arguments "
                        f"{sorted(unknown)}")
    opts.update(kwargs)
    return _highpass(array, mode, **opts)

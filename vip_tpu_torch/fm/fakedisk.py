"""Fake disk injection (port of ``vip_tpu.fm.fakedisk``).

``cube_inject_fakedisk`` rotates one disk model to every parallactic
angle through ``cube_derotate`` (VIP's exact rotation, CUDA kernel H2 on
the card, by default) and convolves all the frames with the PSF in one
batched ``torch.fft`` product, cropped as scipy's ``fftconvolve(...,
mode="same")``. ``cube_inject_trace`` shifts the PSF frame to every
frame's position of a trace point in one ``cube_shift``. Both return
tensors on the model's device (numpy input: the port's device).
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..preproc.derotation import cube_derotate
from ..preproc.recentering import cube_shift
from ..var.coords import dist_matrix, frame_center
from ..var.filters import _fft_convolve_same

__all__ = ["cube_inject_fakedisk", "cube_inject_trace"]


def _psf_kernel(psf, normalize_psf):
    """The 2-d PSF of ``cube_inject_fakedisk`` as host float64 (vip_tpu
    fakedisk.py:40-60): an array (normalized to a sum of 1 if asked and
    it is off by more than 1e-4) or the FWHM of a Gaussian."""
    if isinstance(psf, torch.Tensor):
        psf = psf.detach().cpu().numpy()
    if isinstance(psf, np.ndarray):
        if psf.ndim != 2:
            raise TypeError("Input PSF is not a frame or 2d array.")
        if np.abs(np.sum(psf) - 1) > 1e-4 and normalize_psf:
            print("Warning the PSF is not normalized to a total of 1. "
                  "Normalization was forced.")
            psf = psf / np.sum(psf)
        return np.asarray(psf, dtype=float)
    if isinstance(psf, (int, float)):
        psf_size = 2 * int(np.round(psf)) + 1
        xarr, yarr = np.meshgrid(
            np.arange(-(psf_size // 2), psf_size // 2 + 1),
            np.arange(-(psf_size // 2), psf_size // 2 + 1))
        d = np.sqrt(xarr**2 + yarr**2)
        sigma = psf / (2 * np.sqrt(2 * np.log(2)))
        psf = np.exp(-(d**2 / (2.0 * sigma**2)))
        return psf / np.sum(psf)
    raise TypeError("The type of the psf is unknown. cube_inject_fakedisk "
                    "accepts ndarray, int or float.")


def cube_inject_fakedisk(fakedisk, angle_list, psf=None, transmission=None,
                         normalize_psf=True, **rot_options):
    """Rotate a disk model to each parallactic angle and optionally
    convolve it with the PSF (vip_tpu fakedisk.py:13). ``rot_options`` go
    to ``cube_derotate`` (default imlib 'vip-fft'). Returns a (n, y, x)
    tensor on the model's device."""
    fakedisk = as_tensor(fakedisk).clone()
    if not fakedisk.ndim == 2:
        raise TypeError("Fakedisk is not a frame or a 2d array.")
    angle_list = np.asarray(angle_list.detach().cpu().numpy()
                            if isinstance(angle_list, torch.Tensor)
                            else angle_list)
    if not angle_list.ndim == 1:
        raise TypeError("Input parallactic angle is not a 1d array")

    if transmission is not None:
        if transmission.ndim != 2:
            raise ValueError("transmission should be a 2D ndarray")
        y_star, x_star = frame_center(fakedisk)
        d = dist_matrix(fakedisk.shape[-1], x_star, y_star)
        interp_trans = np.interp(d, transmission[0], transmission[1],
                                 left=0, right=1)
        fakedisk = fakedisk * torch.as_tensor(
            interp_trans, dtype=fakedisk.dtype, device=fakedisk.device)

    nframes = len(angle_list)
    cube = fakedisk.expand(nframes, *fakedisk.shape).contiguous()
    cube = cube_derotate(cube, -np.asarray(angle_list, float), **rot_options)

    if psf is not None:
        kernel = torch.as_tensor(_psf_kernel(psf, normalize_psf),
                                 dtype=cube.dtype, device=cube.device)
        cube = _fft_convolve_same(cube, kernel)
    return cube


def cube_inject_trace(array, psf_template, angle_list, flevel, rad_dists,
                      theta, plsc=0.01225, n_branches=1, imlib="vip-fft",
                      interpolation="lanczos4", verbose=True):
    """Inject the PSF at a trace of polar positions (vip_tpu
    fakedisk.py:64): for each trace point, the PSF frame shifted to every
    frame's position in one ``cube_shift``, times ``flevel``. Returns a
    tensor on the cube's device."""
    array = as_tensor(array)
    if not array.ndim == 3:
        raise TypeError("Array is not a cube or 3d array")
    ceny, cenx = frame_center(array[0])
    ceny = int(ceny)
    cenx = int(cenx)
    rad_dists = np.asarray(rad_dists).reshape(-1)
    theta = np.asarray(theta).reshape(-1)
    if not rad_dists.max() < array[0].shape[0] / 2:
        raise ValueError("rad_dists last location is at the border (or "
                         "outside) of the field")

    psf = as_tensor(psf_template, array.device, array.dtype)
    size_fc = psf.shape[0]
    nframes = array.shape[0]
    fc_fr = torch.zeros_like(array[0])
    w = int(np.floor(size_fc / 2.0))
    odd = size_fc % 2
    fc_fr[ceny - w:ceny + w + odd, cenx - w:cenx + w + odd] = psf
    angs = np.deg2rad(np.asarray(angle_list.detach().cpu().numpy()
                                 if isinstance(angle_list, torch.Tensor)
                                 else angle_list, dtype=float))

    array_out = array.clone()
    copies = fc_fr.expand(nframes, *fc_fr.shape)
    for branch in range(n_branches):
        ang0 = branch * 2 * np.pi / n_branches
        for i in range(rad_dists.shape[0]):
            rad = rad_dists[i]
            ang = ang0 + np.deg2rad(theta[i])
            y = rad * np.sin(ang - angs)
            x = rad * np.cos(ang - angs)
            array_out += cube_shift(copies, y, x, imlib=imlib,
                                    interpolation=interpolation) * flevel
            if verbose:
                posy = rad * np.sin(ang) + ceny
                posx = rad * np.cos(ang) + cenx
                print(f"Branch {branch + 1}, point {i + 1}: "
                      f"(X,Y)=({posx:.2f}, {posy:.2f})")
    return array_out

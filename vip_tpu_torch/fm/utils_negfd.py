"""Utility functions of NEGFD, the negative fake disk (port of
``vip_tpu.fm.utils_negfd``): ``cube_disk_free`` subtracts a shifted,
rotated, rescaled and flux-scaled disk model from a cube, on the cube's
device."""

import numpy as np
import torch

from ..config.device import as_tensor
from ..preproc.cosmetics import cube_crop_frames, frame_pad
from ..preproc.derotation import cube_derotate, frame_rotate
from ..preproc.recentering import cube_shift, frame_shift
from ..preproc.rescaling import cube_rescaling, frame_rescaling
from .fakedisk import cube_inject_fakedisk

__all__ = ["cube_disk_free"]


def cube_disk_free(disk_parameter, cube, derot_angs, disk_img, psfn=None,
                   imlib="vip-fft", interpolation="lanczos4",
                   imlib_sh="vip-fft", interpolation_sh="lanczos4",
                   imlib_sc="vip-fft", interpolation_sc="lanczos4",
                   transmission=None, weights=None, **rot_options):
    """Subtract a shifted, rotated, rescaled and flux-scaled disk model
    from a 3-d or 4-d cube (vip_tpu utils_negfd.py:15).

    ``disk_parameter`` is (delta_x, delta_y, theta, scal, flux); for a 4-d
    cube each may be a vector over the channels ((5, n_ch)). The 4-d
    channels shift in one ``cube_shift``, rotate in one ``cube_derotate``
    and rescale in one batch per distinct scale. Returns a tensor on the
    cube's device."""
    cube = as_tensor(cube)
    disk_model_tmp = as_tensor(disk_img, cube.device, cube.dtype).clone()

    if not isinstance(disk_parameter, np.ndarray):
        if len(disk_parameter) != 5:
            raise TypeError("Wrong length for disk_parameter")

    if cube.ndim == 4:
        n_ch = cube.shape[0]
        if np.isscalar(disk_parameter[-1]) or \
                len(np.atleast_1d(disk_parameter[-1])) != n_ch:
            raise ValueError("Length of flux scaling parameter should match "
                             "cube axis 0")
        if not isinstance(disk_parameter, np.ndarray) or \
                disk_parameter.ndim < 2:
            ndisk_parameter = np.zeros([5, n_ch])
            for j in range(5):
                ndisk_parameter[j, :] = disk_parameter[j]
            disk_parameter = ndisk_parameter
        else:
            disk_parameter = np.array(disk_parameter)
            if disk_parameter.shape[-1] != n_ch:
                raise TypeError("Input disk parameter has wrong dimensions")
        if disk_model_tmp.ndim == 2:
            disk_model_tmp = disk_model_tmp.expand(
                n_ch, *disk_model_tmp.shape).contiguous()
        if psfn is None:
            psfn = [None] * n_ch
        if weights is not None and len(weights) != cube.shape[1]:
            raise TypeError("weights length should match cube axis 1")

        disk_model_tmp = cube_shift(disk_model_tmp, disk_parameter[1],
                                    disk_parameter[0], imlib=imlib_sh,
                                    interpolation=interpolation_sh)
        disk_model_tmp = cube_derotate(disk_model_tmp,
                                       -np.array(disk_parameter[2]),
                                       imlib=imlib,
                                       interpolation=interpolation,
                                       **rot_options)
        disk_model_tmp = cube_rescaling(disk_model_tmp,
                                        list(disk_parameter[3]),
                                        imlib=imlib_sc,
                                        interpolation=interpolation_sc)
        cdf = torch.empty_like(cube)
        for j in range(n_ch):
            disk_rot = cube_inject_fakedisk(
                disk_parameter[4, j] * disk_model_tmp[j], derot_angs,
                psf=psfn[j], transmission=transmission, **rot_options)
            if weights is not None:
                disk_rot = disk_rot * _weights(weights, disk_rot)
            cdf[j] = cube[j] - _match_fov(disk_rot, cube.shape[-1])
        return cdf

    delta_x, delta_y, theta, sc, flevel = (disk_parameter[0],
                                           disk_parameter[1],
                                           disk_parameter[2],
                                           disk_parameter[3],
                                           disk_parameter[4])
    disk_model_tmp = frame_shift(disk_model_tmp, delta_y, delta_x,
                                 imlib=imlib_sh,
                                 interpolation=interpolation_sh)
    disk_model_tmp = frame_rotate(disk_model_tmp, theta, imlib=imlib,
                                  interpolation=interpolation, **rot_options)
    disk_model_tmp = frame_rescaling(disk_model_tmp, scale=sc,
                                     imlib=imlib_sc,
                                     interpolation=interpolation_sc)
    disk_rot = cube_inject_fakedisk(flevel * disk_model_tmp, derot_angs,
                                    psf=psfn, transmission=transmission,
                                    **rot_options)
    if weights is not None:
        if len(weights) != cube.shape[0]:
            raise TypeError("weights length should match cube axis 0")
        disk_rot = disk_rot * _weights(weights, disk_rot)
    return cube - _match_fov(disk_rot, cube.shape[-1])


def _weights(weights, like):
    w = weights.detach() if isinstance(weights, torch.Tensor) \
        else np.asarray(weights, dtype=float)
    return torch.as_tensor(w, dtype=like.dtype,
                           device=like.device)[:, None, None]


def _match_fov(disk_rot, target_size):
    """Pad (with zeros, centered as ``frame_pad`` without parity) or crop
    a rotated disk cube to the cube's field of view (vip_tpu
    utils_negfd.py:106)."""
    if disk_rot.shape[-1] < target_size:
        pad_fac = target_size / disk_rot.shape[-1]
        first, (y0, y1, x0, x1) = frame_pad(disk_rot[0], pad_fac,
                                            fillwith=0, keep_parity=False,
                                            full_output=True)
        out = disk_rot.new_zeros((disk_rot.shape[0],) + tuple(first.shape))
        out[:, y0:y1, x0:x1] = disk_rot
        return out
    if disk_rot.shape[-1] > target_size:
        return cube_crop_frames(disk_rot, target_size, force=True,
                                verbose=False)
    return disk_rot

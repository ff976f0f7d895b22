"""Annular PCA for 3-d ADI/RDI cubes (port of ``vip_tpu.psfsub.pca_local``).

PCA on concentric annuli (or annular sectors) with a parallactic-angle
rejection threshold. Per annulus, the PA threshold and the ΔPA-truncated
libraries are host control data (numpy); the segment matrices, the
batched per-frame PCA (``ops.annular``), the derotation (CUDA kernels H2
or H3 on the card) and the collapse (H1) run on the cube's device.

Two branches, as in vip_tpu:

- the device-resident branch (:func:`_pca_adi_resident`) for ADI cubes of
  at least 128 frames with an int ``ncomp`` and no reference cube,
  ``cube_sig``, ``weights``, ``left_eigv``, ``scaling`` or rotation
  options, and a 'vip-fft' or 'vip-fft-small' derotation: the cube stays
  on its device from the segment gather to the collapse;
- the host-orchestrated branch for everything else (int, per-annulus
  tuple, list grid and "auto" ``ncomp``; RDI ``cube_ref``; ``cube_sig``;
  ``left_eigv``; ``scaling``; ``weights``).

A 4-d (channels, frames, y, x) cube without ``scale_list`` is reduced
channel by channel and the channel frames collapse (``collapse_ifs``).
With ``scale_list`` each temporal frame first gets a spectral annular
PCA (:func:`_pca_sdi_fr`: the channels of all frames rescaled in one
batched zoom a channel, and for each annulus and segment the PCAs of
all frames and channels in one batched SVD, since the SDI library
depends only on the annulus and the channel), then the
channel-collapsed frames go through the 3-d annular ADI stage (skipped
when its ``ncomp`` is None).

Results are tensors on the cube's device.
"""

import os
from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple, Union

import numpy as np
import torch

from ..config import Collapse, Imlib, Interpolation, SvdMode, time_ini, timing
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params, setup_parameters
from ..ops.annular import (batched_pca_patch_residuals,
                           batched_pca_patch_residuals_gram,
                           resident_annulus_update)
from ..preproc.derotation import (_define_annuli, _find_indices_adi,
                                  cube_derotate)
from ..preproc.parangles import check_pa_vector
from ..preproc.subsampling import cube_collapse
from ..var.shapes import (get_annulus_segments, matrix_scaling,
                          resolve_n_segments)
from .pca_fullfr import _value
from .svd import MODE_TO_METHOD, get_eigenvectors

__all__ = ["pca_annular", "PCA_ANNULAR_Params"]

# Frames from which the Gram-space path takes over (the masked path is
# cubic in frames). VIP_TPU_ANNULAR_GRAM=1/0 forces either path.
_GRAM_PATH_MIN_FRAMES = 128

# Frames from which the resident path takes the subspace iteration
# (ops.annular._subspace_topk) instead of the exact per-frame eigh.
# VIP_TPU_ANNULAR_METHOD=eigh|subspace forces either; the choice changes
# the outputs at float resolution, so the default stays vip_tpu's.
_SUBSPACE_MIN_FRAMES = 512


def _resident_method(n, svd_val):
    env = os.environ.get("VIP_TPU_ANNULAR_METHOD")
    if env in ("eigh", "subspace"):
        return env
    if MODE_TO_METHOD.get(svd_val) == "randsvd":
        return "subspace"
    return "subspace" if n >= _SUBSPACE_MIN_FRAMES else "eigh"


def _gram_path_enabled(n):
    env = os.environ.get("VIP_TPU_ANNULAR_GRAM")
    if env is not None:
        return env == "1"
    return n >= _GRAM_PATH_MIN_FRAMES


def _build_lib_masks(angle_list, pa_thr, n, min_frames_lib, max_frames_lib,
                     have_ref):
    """Per-frame library masks (n, n) and sizes for one annulus: the PA
    threshold and the ΔPA-sorted truncation (vip_tpu pca_local.py:71)."""
    if pa_thr != 0:
        lib_mask = np.zeros((n, n), dtype=bool)
        lib_sizes = np.zeros(n, dtype=int)
        for fr in range(n):
            idx = _find_indices_adi(angle_list, fr, pa_thr, truncate=True,
                                    max_frames=max_frames_lib)
            lib_mask[fr, idx] = True
            lib_sizes[fr] = len(idx)
        if not have_ref and lib_sizes.min() < min_frames_lib:
            raise RuntimeError(
                "Too few frames left in the PCA library. Accepted "
                f"indices length ({lib_sizes.min():.0f}) less than "
                f"{min_frames_lib:.0f}. Try decreasing either delta_rot "
                "or min_frames_lib.")
        return lib_mask, lib_sizes
    return np.ones((n, n), dtype=bool), np.full(n, n)


def _pad_lib_arrays(lib_mask, lib_sizes, n, npc_max, max_frames_lib, dtype):
    """(lib_idx, lib_w) host arrays padded to a shared library size L_pad:
    the next multiple of 64, or ``max_frames_lib`` when that caps the
    libraries, at least ``npc_max`` and at most n (vip_tpu
    pca_local.py:93). L_pad is also the row count of the subspace
    iteration's starting block."""
    L = int(lib_sizes.max())
    L_pad = 64 * ((L + 63) // 64)
    if L <= max_frames_lib < L_pad:
        L_pad = int(max_frames_lib)
    L_pad = min(n, max(npc_max, L_pad))
    lib_idx = np.zeros((n, L_pad), dtype=np.int64)
    lib_w = np.zeros((n, L_pad), dtype=dtype)
    for fr in range(n):
        idx = np.flatnonzero(lib_mask[fr])
        lib_idx[fr, :idx.size] = idx
        lib_w[fr, :idx.size] = 1.0
    return lib_idx, lib_w


def _resident_chunk(n, y, rot_mode):
    """Frames per derotation chunk of the resident path, vip_tpu's formula
    (pca_local.py:183-186). The fft-small mode pairs frames in packs, so
    the chunk decides the packed path's numbers."""
    canvas = (4 * y) ** 2 * 8 if rot_mode == "fft" \
        else (int(1.25 * y) + 2) ** 2 * 8
    return int(min(n, 128, max(8, 1.6e9 // canvas)))


def _pca_adi_resident(array, angle_list, radius_int, fwhm, asize,
                      n_segments, delta_rot, ncomp, min_frames_lib,
                      max_frames_lib, collapse, rot_mode, theta_init,
                      full_output, verbose, start_time, method="eigh"):
    """Device-resident annular ADI PCA (vip_tpu pca_local.py:110): segment
    gather, Gram-path PCA and residual scatter per annulus segment
    (``ops.annular.resident_annulus_update``), then one derotation and
    collapse, all on the cube's device. Returns (cube_out, cube_der,
    frame), the cubes None unless ``full_output``."""
    from ..ops.pipeline import _derotate_frames
    from ..preproc.subsampling import collapse_jax

    n, y, x = array.shape
    dev = array.device
    n_annuli = len(n_segments)
    cube_out = torch.zeros_like(array)
    np_dtype = np.float32 if array.dtype == torch.float32 else np.float64

    if verbose:
        print(f"N annuli = {n_annuli}, FWHM = {fwhm:.3f}")
        print("PCA per annulus (or annular sectors) [device-resident]:")

    for ann in range(n_annuli):
        ncompann = int(ncomp)
        n_segments_ann = n_segments[ann]
        pa_thr, inner_radius, _ = _define_annuli(
            angle_list, ann, n_annuli, fwhm, radius_int, asize,
            delta_rot[ann], n_segments_ann, verbose, True)
        indices = get_annulus_segments((y, x), inner_radius, asize,
                                       n_segments_ann, theta_init)
        lib_mask, lib_sizes = _build_lib_masks(
            angle_list, pa_thr, n, min_frames_lib, max_frames_lib, False)
        lib_idx, lib_w = _pad_lib_arrays(lib_mask, lib_sizes, n, ncompann,
                                         max_frames_lib, np_dtype)
        k_eff = np.minimum(ncompann, lib_sizes)
        lib_idx_d = torch.as_tensor(lib_idx, device=dev)
        lib_w_d = torch.as_tensor(lib_w, device=dev)

        for j in range(n_segments_ann):
            yy, xx = indices[j]
            flat = np.asarray(yy, np.int64) * x + np.asarray(xx, np.int64)
            resident_annulus_update(
                array, cube_out, torch.as_tensor(flat, device=dev),
                torch.ones(flat.size, dtype=array.dtype, device=dev),
                lib_idx_d, lib_w_d,
                torch.as_tensor(np.minimum(k_eff, flat.size), device=dev),
                ncompann, method=method)

        if verbose == 1:
            print("Done PCA with lapack for current annulus")
            timing(start_time)

    ang = torch.as_tensor(angle_list, dtype=array.dtype, device=dev)
    cube_der = _derotate_frames(cube_out, ang,
                                chunk=_resident_chunk(n, y, rot_mode),
                                rot_mode=rot_mode)
    frame = collapse_jax(cube_der, mode=collapse)

    if verbose:
        print("Done derotating and combining.")
        timing(start_time)
    if full_output:
        return cube_out, cube_der, frame
    return None, None, frame


@dataclass
class PCA_ANNULAR_Params:
    """Parameters of ``pca_annular`` (vip_tpu pca_local.py:202; VIP
    pca_local.py:39-70). Arrays may be numpy arrays or tensors."""

    cube: object = None
    angle_list: object = None
    cube_ref: object = None
    scale_list: object = None
    radius_int: int = 0
    fwhm: float = 4
    asize: float = 4
    n_segments: Union[int, List[int], str] = 1
    delta_rot: Union[float, Tuple[float], List[float]] = (0.1, 1)
    delta_sep: Union[float, Tuple[float], List[float]] = (0.1, 1)
    ncomp: Union[int, Tuple, np.ndarray, str] = 1
    svd_mode: Enum = SvdMode.LAPACK
    nproc: int = 1
    min_frames_lib: int = 2
    max_frames_lib: int = 200
    tol: float = 1e-1
    scaling: Enum = None
    imlib: Enum = Imlib.VIPFFT
    interpolation: Enum = Interpolation.LANCZOS4
    collapse: Enum = Collapse.MEDIAN
    collapse_ifs: Enum = Collapse.MEAN
    ifs_collapse_range: Union[str, Tuple[int]] = "all"
    theta_init: int = 0
    weights: object = None
    cube_sig: object = None
    full_output: bool = False
    verbose: bool = True
    left_eigv: bool = False


def pca_annular(*all_args: List, **all_kwargs: dict):
    """PCA on concentric annuli (or annular sectors) of a 3-d ADI/RDI cube
    with a parallactic-angle rejection threshold (vip_tpu
    pca_local.py:236).

    Returns the final frame, or with ``full_output`` (cube_out, cube_der,
    frame): the residual cube, the derotated residual cube and the frame,
    as tensors on the cube's device (lists of frames and 4-d cubes for a
    list ``ncomp``). A 4-d cube returns the same triple (vip_tpu
    pca_local.py:265-377): per channel without ``scale_list``, the SDI and
    ADI stages with it.
    """
    algo_params, rot_options = resolve_algo_params(
        PCA_ANNULAR_Params, all_args, all_kwargs)

    if algo_params.radius_int and len(rot_options) == 0:
        rot_options["mask_val"] = 0
        rot_options["ker"] = 1
        rot_options["interp_zeros"] = True

    ndim = getattr(algo_params.cube, "ndim", None)
    if ndim == 4 and algo_params.scale_list is None:
        return _pca_annular_channels(algo_params, rot_options)
    if ndim == 4:
        return _pca_annular_sdi(algo_params, rot_options)
    if ndim != 3:
        raise TypeError("Input array is not a 4d or 3d array")

    add_params = {"start_time": time_ini(bool(algo_params.verbose)),
                  "full_output": bool(algo_params.full_output)}
    func_params = setup_parameters(params_obj=algo_params, fkt=_pca_adi_rdi,
                                   **add_params)
    res = _pca_adi_rdi(**func_params, **rot_options)
    if algo_params.full_output:
        return res
    return res[2] if isinstance(res, tuple) else res


def _pca_annular_channels(p, rot_options):
    """4-d ``pca_annular`` without ``scale_list``: the 3-d annular PCA of
    each channel, then the channel frames collapse (vip_tpu
    pca_local.py:265-302)."""
    cube = as_tensor(p.cube)
    nch = cube.shape[0]
    ncomp = p.ncomp
    if not isinstance(ncomp, list) or len(ncomp) != nch:
        ncomp = [p.ncomp] * nch
    fwhm = [p.fwhm] * nch if np.isscalar(p.fwhm) else p.fwhm
    cube_out, cube_der, frames = [], [], []
    for ch in range(nch):
        cube_ref_tmp = None
        if p.cube_ref is not None:
            if p.cube_ref[ch].ndim != 3:
                raise TypeError("Ref cube has wrong format for 4d input cube")
            cube_ref_tmp = p.cube_ref[ch]
        add_params = {"cube": cube[ch], "fwhm": fwhm[ch], "ncomp": ncomp[ch],
                      "full_output": True, "cube_ref": cube_ref_tmp,
                      "start_time": time_ini(False)}
        func_params = setup_parameters(params_obj=p, fkt=_pca_adi_rdi,
                                       **add_params)
        res = _pca_adi_rdi(**func_params, **rot_options)
        cube_out.append(res[0])
        cube_der.append(res[1])
        frames.append(res[-1])
    ifs_adi_frames = torch.stack(frames)
    frame = cube_collapse(ifs_adi_frames, mode=str(_value(p.collapse_ifs))) \
        if p.collapse_ifs is not None else ifs_adi_frames
    if p.full_output:
        return torch.stack(cube_out), torch.stack(cube_der), frame
    return frame


def _pca_annular_sdi(p, rot_options):
    """4-d ``pca_annular`` with ``scale_list``: the spectral annular PCA
    of every temporal frame, then the annular ADI stage on the
    channel-collapsed frames, or, when its ncomp is None, their
    derotation and collapse (vip_tpu pca_local.py:304-377)."""
    from ..preproc.rescaling import _host_vec

    cube = as_tensor(p.cube)
    z, n, y_in, x_in = cube.shape
    fwhm = int(np.round(np.mean(p.fwhm)))
    scale_list = _host_vec(p.scale_list)
    if scale_list.ndim > 1:
        raise ValueError("Scaling factors vector is not 1d")
    if not scale_list.shape[0] == z:
        raise ValueError("Scaling factors vector has wrong length")
    if not isinstance(p.ncomp, tuple):
        raise TypeError("`ncomp` must be a tuple of two integers when "
                        "`cube` is a 4d array")
    ncomp1, ncomp2 = p.ncomp
    svd_mode = str(_value(p.svd_mode))
    collapse_ifs = str(_value(p.collapse_ifs))
    if p.verbose:
        print("First PCA subtraction exploiting the spectral variability")
        print(f"{z} spectral channels per IFS frame")

    def sdi(c4):
        return _pca_sdi_fr(c4, None, scale_list, p.radius_int, fwhm,
                           p.asize, p.n_segments, p.delta_sep, ncomp1,
                           svd_mode, p.tol, p.scaling, p.imlib,
                           p.interpolation, collapse_ifs,
                           p.ifs_collapse_range, p.theta_init)

    residuals_cube_channels = sdi(cube)
    if ncomp2 is None:
        cube_out = residuals_cube_channels
        cube_der = cube_derotate(cube_out, check_pa_vector(p.angle_list),
                                 nproc=p.nproc, imlib=_value(p.imlib),
                                 interpolation=_value(p.interpolation),
                                 **rot_options)
        frame = cube_collapse(cube_der, mode=_value(p.collapse),
                              w=p.weights)
    else:
        ref_channels = None
        if p.cube_ref is not None:
            ref_channels = sdi(as_tensor(p.cube_ref, cube.device,
                                         cube.dtype))
        add_params = {"cube": residuals_cube_channels, "ncomp": ncomp2,
                      "cube_ref": ref_channels, "fwhm": fwhm,
                      "start_time": time_ini(False), "full_output": True}
        func_params = setup_parameters(params_obj=p, fkt=_pca_adi_rdi,
                                       **add_params)
        cube_out, cube_der, frame = _pca_adi_rdi(**func_params,
                                                 **rot_options)
    if p.full_output:
        return cube_out, cube_der, frame
    return frame


def _pca_sdi_fr(array, fr, scal, radius_int, fwhm, asize, n_segments,
                delta_sep, ncomp, svd_mode, tol, scaling, imlib,
                interpolation, collapse, ifs_collapse_range, theta_init):
    """Spectral annular PCA of the temporal frames ``fr`` (indices, or None
    for all) of a (z, n, y, x) cube (vip_tpu pca_local.py:380, one frame
    there). The channels' SDI libraries (``_find_indices_sdi``) depend on
    the annulus and the channel only, so each (annulus, segment) is one
    batched SVD over the frames and channels (int ``ncomp`` with the
    'lapack' or 'eigen' method, :func:`_sdi_recon_batched`; channel by
    channel where ``ncomp`` exceeds a library; 'auto' and the randomized
    modes frame by frame through ``get_eigenvectors``). Returns
    (len(fr), y, x): the residual channels rescaled back and
    collapsed."""
    from ..preproc.rescaling import (_find_indices_sdi, _scwave,
                                     check_scal_vector)
    from ..ops.linalg import matrix_scaling_jax, svd_top

    array = as_tensor(array)
    if fr is not None:
        array = array[:, fr]
    scale_list = check_scal_vector(scal)
    z, N, y_in, x_in = array.shape
    imlib = _value(imlib)
    interpolation = _value(interpolation)
    scaling = _value(scaling)
    multispec = _scwave(array, scale_list, imlib=imlib,
                        interpolation=interpolation, collapse=None)[0]
    Y, X = multispec.shape[-2:]
    fwhm = int(np.round(np.mean(fwhm)))
    n_annuli = int((y_in / 2 - radius_int) / asize)
    n_segments = resolve_n_segments(n_segments, n_annuli, asize)
    if isinstance(delta_sep, (tuple, list)):
        delta_sep_vec = np.linspace(delta_sep[0], delta_sep[1], n_annuli)
    elif np.isscalar(delta_sep):
        delta_sep_vec = [delta_sep] * n_annuli
    else:
        if len(delta_sep) != n_annuli:
            raise TypeError("If delta_sep is a list it should have n_annuli "
                            "elements.")
        delta_sep_vec = delta_sep
    method = MODE_TO_METHOD.get(svd_mode)
    batched = isinstance(ncomp, (int, np.integer)) \
        and method in ("lapack", "eigen")

    flat = multispec.reshape(z, N, Y * X)
    res_flat = torch.zeros_like(flat)
    for ann in range(n_annuli):
        if ann == n_annuli - 1:
            inner_radius = radius_int + (ann * asize - 1)
        else:
            inner_radius = radius_int + ann * asize
        ann_center = inner_radius + (asize / 2)
        indices = get_annulus_segments((Y, X), inner_radius, asize,
                                       n_segments[ann], theta_init)
        for seg in range(n_segments[ann]):
            yy, xx = indices[seg]
            pix = torch.as_tensor(np.asarray(yy) * X + np.asarray(xx),
                                  device=flat.device)
            # (N, z, p): each frame's channels, scaled along the channels
            matrix = matrix_scaling_jax(flat[:, :, pix].transpose(0, 1),
                                        scaling)
            libs = [_find_indices_sdi(scal, ann_center, j, fwhm,
                                      delta_sep_vec[ann]) for j in range(z)]
            ks = {min(int(ncomp), len(lib), len(pix)) for lib in libs} \
                if batched else set()
            if len(ks) == 1:
                recon = _sdi_recon_batched(matrix, libs, ks.pop(), method)
                res_flat[:, :, pix] = (matrix - recon).transpose(0, 1)
                continue
            for j in range(z):
                lib = matrix[:, torch.as_tensor(libs[j], device=flat.device)]
                curr = matrix[:, j]
                if batched:
                    k = min(int(ncomp), min(lib.shape[-2], lib.shape[-1]))
                    V = svd_top(lib, k, method=method)
                    recon = torch.einsum("nk,nkp->np",
                                         torch.einsum("np,nkp->nk", curr, V),
                                         V)
                else:
                    recon = torch.stack([
                        (curr[f] @ V.T) @ V for f, V in enumerate(
                            get_eigenvectors(ncomp, lib[f], svd_mode,
                                             noise_error=tol, debug=False,
                                             scaling=scaling)
                            for f in range(N))])
                res_flat[j, :, pix] = curr - recon
    idx_ini, idx_fin = (0, z) if ifs_collapse_range == "all" \
        else ifs_collapse_range
    return _scwave(res_flat.reshape(z, N, Y, X)[idx_ini:idx_fin],
                   scale_list[idx_ini:idx_fin], inverse=True, y_in=y_in,
                   x_in=x_in, imlib=imlib, interpolation=interpolation,
                   collapse=_value(collapse), keep_cube=False)[1]


def _sdi_recon_batched(matrix, libs, k, method):
    """The rank-``k`` reconstruction of each channel of each frame of a
    (N, z, p) ``matrix`` from its channel library ``libs[j]``, all N·z
    libraries in one ``svd_top`` call: each library padded with zero rows
    to the longest, which leaves its top singular vectors as they are.
    Returns (N, z, p)."""
    from ..ops.linalg import svd_top

    N, z, npx = matrix.shape
    L = max(len(lib) for lib in libs)
    padded = np.full((z, L), z, dtype=np.int64)     # row z is all zero
    for j, lib in enumerate(libs):
        padded[j, :len(lib)] = lib
    ext = torch.cat([matrix, matrix.new_zeros((N, 1, npx))], dim=1)
    lib_all = ext[:, torch.as_tensor(padded, device=matrix.device)]
    V = svd_top(lib_all.reshape(N * z, L, npx), k, method=method)
    V = V.reshape(N, z, k, npx)
    return torch.einsum("nzk,nzkp->nzp",
                        torch.einsum("nzp,nzkp->nzk", matrix, V), V)


def _pca_adi_rdi(cube, angle_list, radius_int=0, fwhm=4, asize=2,
                 n_segments=1, delta_rot=1, ncomp=1, svd_mode="lapack",
                 nproc=None, min_frames_lib=2, max_frames_lib=200, tol=1e-1,
                 scaling=None, imlib="vip-fft", interpolation="lanczos4",
                 collapse="median", full_output=False, verbose=1,
                 cube_ref=None, theta_init=0, weights=None, cube_sig=None,
                 left_eigv=False, start_time=None, **rot_options):
    """Annular ADI/RDI PCA core (vip_tpu pca_local.py:447)."""
    array = as_tensor(cube if isinstance(cube, torch.Tensor)
                      else np.asarray(cube, dtype=float))
    if array.ndim != 3:
        raise TypeError("Input array is not a cube or 3d array")
    angle_list = check_pa_vector(angle_list)
    if array.shape[0] != angle_list.shape[0]:
        raise TypeError("Input vector or parallactic angles has wrong length")
    if start_time is None:
        start_time = time_ini(False)
    dev, dtype = array.device, array.dtype
    if cube_ref is not None:
        cube_ref = as_tensor(cube_ref, dev, dtype)
    if cube_sig is not None:
        cube_sig = as_tensor(cube_sig, dev, dtype)

    n, y, x = array.shape
    n_annuli = int((y / 2 - radius_int) / asize)

    if isinstance(delta_rot, tuple):
        delta_rot = np.linspace(delta_rot[0], delta_rot[1], num=n_annuli)
    elif np.isscalar(delta_rot):
        delta_rot = [delta_rot] * n_annuli
    elif len(delta_rot) != n_annuli:
        raise TypeError("If delta_rot is a list it should have n_annuli "
                        "elements.")

    if isinstance(n_segments, int):
        n_segments = [n_segments for _ in range(n_annuli)]
    elif n_segments == "auto":
        n_segments = resolve_n_segments("auto", n_annuli, asize)

    imlib_val = str(_value(imlib))
    collapse_val = str(_value(collapse))
    svd_val = str(_value(svd_mode))
    if (_gram_path_enabled(n) and cube_ref is None and cube_sig is None
            and weights is None and not left_eigv
            and isinstance(ncomp, (int, np.integer))
            and scaling is None and not rot_options
            and imlib_val in ("vip-fft", "vip-fft-small")
            and not (imlib_val == "vip-fft-small"
                     and (y != x or x % 2 != 0))
            and collapse_val in ("median", "mean", "sum")):
        rot_mode = "fft-small" if imlib_val == "vip-fft-small" else "fft"
        return _pca_adi_resident(
            array, angle_list, radius_int, fwhm, asize, n_segments,
            delta_rot, ncomp, min_frames_lib, max_frames_lib, collapse_val,
            rot_mode, theta_init, full_output, verbose, start_time,
            method=_resident_method(n, svd_val))

    if verbose:
        print(f"N annuli = {n_annuli}, FWHM = {fwhm:.3f}")
        print("PCA per annulus (or annular sectors):")

    ncomp_list = isinstance(ncomp, list)
    cube_out = torch.zeros((len(ncomp), n, y, x), dtype=dtype, device=dev) \
        if ncomp_list else torch.zeros_like(array)
    verbose_ann = int(verbose) + int(cube_ref is None) if verbose else verbose
    method = MODE_TO_METHOD.get(svd_val, "lapack")
    scaling = _value(scaling)

    for ann in range(n_annuli):
        if isinstance(ncomp, (tuple, np.ndarray)):
            if len(ncomp) != n_annuli:
                raise TypeError("If `ncomp` is a tuple, its length must "
                                "match the number of annuli")
            ncompann = ncomp[ann]
        else:
            ncompann = ncomp

        n_segments_ann = n_segments[ann]
        pa_thr, inner_radius, _ = _define_annuli(
            angle_list, ann, n_annuli, fwhm, radius_int, asize,
            delta_rot[ann], n_segments_ann, verbose_ann, True)
        indices = get_annulus_segments((y, x), inner_radius, asize,
                                       n_segments_ann, theta_init)
        if left_eigv:
            indices_out = get_annulus_segments((y, x), inner_radius, asize,
                                               n_segments_ann, theta_init,
                                               out=True)
        lib_mask, lib_sizes = _build_lib_masks(
            angle_list, pa_thr, n, min_frames_lib, max_frames_lib,
            cube_ref is not None)

        for j in range(n_segments_ann):
            yy, xx = (torch.as_tensor(i, device=dev) for i in indices[j])
            matrix_segm = matrix_scaling(array[:, yy, xx], scaling)
            matrix_segm_ref = None
            if cube_ref is not None:
                matrix_segm_ref = matrix_scaling(cube_ref[:, yy, xx], scaling)
            matrix_sig_segm = cube_sig[:, yy, xx] if cube_sig is not None \
                else None

            if left_eigv:
                yy_o, xx_o = (torch.as_tensor(i, device=dev)
                              for i in indices_out[j])
                matrix_out_segm = matrix_scaling(array[:, yy_o, xx_o],
                                                 scaling)
                npc = max(ncomp) if ncomp_list else ncomp
                V = get_eigenvectors(npc, matrix_out_segm, svd_val,
                                     noise_error=tol, left_eigv=True)
                for nn, npc_tmp in (enumerate(ncomp) if ncomp_list
                                    else [(None, None)]):
                    Vk = V[:npc_tmp]
                    reconstructed = (Vk @ matrix_segm).T @ Vk
                    if nn is None:
                        cube_out[:, yy, xx] = matrix_segm - reconstructed.T
                    else:
                        cube_out[nn][:, yy, xx] = \
                            matrix_segm - reconstructed.T
                continue

            matrix_emp = matrix_segm if matrix_sig_segm is None \
                else matrix_segm - matrix_sig_segm

            if ncompann == "auto":
                # data-dependent truncation: one decomposition per frame
                residuals = torch.empty_like(matrix_segm)
                for fr in range(n):
                    data_ref = matrix_emp[torch.as_tensor(lib_mask[fr],
                                                          device=dev)]
                    if matrix_segm_ref is not None:
                        data_ref = torch.cat((matrix_segm_ref, data_ref))
                    V = get_eigenvectors("auto", data_ref, svd_val,
                                         noise_error=tol)
                    residuals[fr] = matrix_segm[fr] - \
                        (matrix_emp[fr] @ V.T) @ V
                cube_out[:, yy, xx] = residuals
                continue

            npc_max = max(ncompann) if isinstance(ncompann, list) \
                else int(ncompann)
            n_ref_rows = 0 if matrix_segm_ref is None \
                else matrix_segm_ref.shape[0]
            # per-frame effective ncomp: min(ncomp, library rows, n_px)
            k_eff = np.minimum(npc_max,
                               np.minimum(lib_sizes + n_ref_rows,
                                          matrix_segm.shape[1]))
            use_gram = (matrix_segm_ref is None
                        and not isinstance(ncompann, list)
                        and _gram_path_enabled(n))
            if use_gram:
                lib_idx, lib_w = _pad_lib_arrays(
                    lib_mask, lib_sizes, n, npc_max, max_frames_lib,
                    np.float32 if dtype == torch.float32 else np.float64)
                res = batched_pca_patch_residuals_gram(
                    matrix_segm, matrix_emp, lib_idx, lib_w, npc_max,
                    k_eff=k_eff)
            else:
                res, V_all = batched_pca_patch_residuals(
                    matrix_segm, matrix_emp, lib_mask, npc_max,
                    method=method, matrix_ref=matrix_segm_ref, k_eff=k_eff)

            if isinstance(ncompann, list):
                for nn, npc_tmp in enumerate(ncompann):
                    for fr in range(n):
                        V = V_all[fr][:min(npc_tmp, int(k_eff[fr]))]
                        cube_out[nn, fr, yy, xx] = matrix_segm[fr] - \
                            (matrix_emp[fr] @ V.T) @ V
            else:
                cube_out[:, yy, xx] = res

        if verbose == 1:
            print(f"Done PCA with {svd_mode} for current annulus")
            timing(start_time)

    rot = dict(nproc=nproc, imlib=imlib_val,
               interpolation=_value(interpolation), **rot_options)
    if ncomp_list:
        cube_der = torch.stack([cube_derotate(c, angle_list, **rot)
                                for c in cube_out])
        frame = [cube_collapse(c, mode=collapse_val, w=weights)
                 for c in cube_der]
    else:
        cube_der = cube_derotate(cube_out, angle_list, **rot)
        frame = cube_collapse(cube_der, mode=collapse_val, w=weights)

    if verbose:
        print("Done derotating and combining.")
        timing(start_time)
    if full_output:
        return cube_out, cube_der, frame
    return frame


def do_pca_patch(matrix, frame, angle_list, fwhm, pa_threshold, ann_center,
                 svd_mode, ncomp, min_frames_lib, max_frames_lib, tol,
                 matrix_ref, matrix_sig_segm):
    """SVD/PCA of one frame's annulus patch against its PA-thresholded
    library (vip_tpu pca_local.py:721; VIP pca_local.py:830-910), for
    callers that drive the per-frame decomposition themselves.

    Returns (residuals, ncomp_used, library_size); the residuals are a
    list of tensors for a list ``ncomp``.
    """
    matrix = as_tensor(matrix)
    dev, dtype = matrix.device, matrix.dtype
    if matrix_sig_segm is not None:
        matrix_sig_segm = as_tensor(matrix_sig_segm, dev, dtype)
    if matrix_ref is not None:
        matrix_ref = as_tensor(matrix_ref, dev, dtype)
    matrix_emp = matrix if matrix_sig_segm is None \
        else matrix - matrix_sig_segm
    if pa_threshold != 0:
        indices_left = _find_indices_adi(check_pa_vector(angle_list), frame,
                                         pa_threshold, truncate=True,
                                         max_frames=max_frames_lib)
        data_ref = matrix_emp[torch.as_tensor(indices_left, device=dev)]
        if data_ref.shape[0] < min_frames_lib and matrix_ref is None:
            raise RuntimeError(
                "Too few frames left in the PCA library. Accepted indices "
                f"length ({len(indices_left):.0f}) less than "
                f"{min_frames_lib:.0f}. Try decreasing either delta_rot or "
                "min_frames_lib.")
    else:
        data_ref = matrix_emp
    if matrix_ref is not None:
        data_ref = torch.cat((matrix_ref, data_ref))

    curr_frame = matrix[frame]
    curr_frame_emp = matrix_emp[frame]
    npc = max(ncomp) if isinstance(ncomp, list) else ncomp
    V = get_eigenvectors(npc, data_ref, svd_mode, noise_error=tol)
    if isinstance(ncomp, list):
        residuals = [curr_frame - (curr_frame_emp @ V[:k].T) @ V[:k]
                     for k in ncomp]
    else:
        residuals = curr_frame - (curr_frame_emp @ V.T) @ V
    return residuals, V.shape[0], data_ref.shape[0]

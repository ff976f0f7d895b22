"""Full-frame PCA for ADI / RDI / ARDI 3-d cubes and ADI+mSDI 4-d cubes
(port of ``vip_tpu.psfsub.pca_fullfr``).

Same public surface as vip_tpu's ``pca(*args, **kwargs)``: the
dataclass-params convention, keyword arguments outside ``PCA_Params``
passed on as ``rot_options``, and the same return tuples. The pipeline
prepare-matrix → SVD → project/subtract → derotate (CUDA kernel H2, or H4
with ``VIP_EXACT_SHEAR=fused3``) → collapse (CUDA kernel H1) runs on the
cube's device; results are tensors there. A tuple or list ``ncomp`` is a
grid (``utils_pca.pca_grid``), a float ``ncomp`` the number of PCs that
reach that cumulative explained variance ratio (``svd.SVDecomposer``),
and ``left_eigv`` projects on the left singular vectors. ``mask_rdi``
runs the sky-subtraction PCA of ``preproc.cube_subtract_sky_pca``.

A 4-d (channels, frames, y, x) cube without ``scale_list`` is reduced
channel by channel and the channel frames collapse (``collapse_ifs``).
With ``scale_list`` (ADI+mSDI): the single pass rescales every channel
to align the speckles (one batched FFT zoom a channel over all frames,
``preproc.rescaling``), runs one PCA of the z·n frames, rescales back,
collapses the channels, derotates and collapses; the double pass runs
one spectral PCA a temporal frame, all of them in one batched
``ops.linalg.svd_top`` call, then the ADI stage.

``batch`` streams the cube through ``utils_pca.pca_incremental`` (a
FITS path is read lazily) and returns host numpy results, as vip_tpu.

``smooth`` convolves the final frame of a 3-d cube with a Gaussian of
that FWHM (``var.frame_filter_lowpass``), before the central mask, as
vip_tpu does in ``_adi_rdi_pca`` alone: a grid ``ncomp``, ``batch`` and
4-d cubes ignore it there, and here.
"""

from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple, Union

import numpy as np
import torch

from ..config import (Adimsdi, Collapse, Imlib, Interpolation, SvdMode,
                      check_array, check_enough_memory, time_ini, timing)
from ..config.device import as_tensor
from ..config.utils_param import resolve_algo_params, setup_parameters
from ..ops.linalg import matrix_scaling_jax, project_subtract, svd_top
from ..preproc.derotation import (_compute_pa_thresh, _find_indices_adi,
                                  cube_derotate)
from ..preproc.parangles import check_pa_vector
from ..preproc.subsampling import cube_collapse
from ..preproc.cosmetics import cube_crop_frames
from ..preproc.rescaling import _host_vec, _scwave
from ..var.coords import dist, frame_center
from ..var.shapes import mask_circle, prepare_matrix
from .svd import MODE_TO_METHOD, SVDecomposer, svd_wrapper

__all__ = ["pca", "PCA_Params"]

@dataclass
class PCA_Params:
    """Parameters of ``pca`` (vip_tpu pca_fullfr.py:40; VIP
    pca_fullfr.py:93-135). Arrays may be numpy arrays or tensors."""

    cube: object = None
    angle_list: object = None
    cube_ref: object = None
    scale_list: object = None
    ncomp: Union[Tuple, List, float, int] = 1
    svd_mode: Enum = SvdMode.LAPACK
    scaling: Enum = None
    mask_center_px: int = None
    source_xy: Tuple[int] = None
    delta_rot: int = None
    fwhm: float = 4
    adimsdi: Enum = Adimsdi.SINGLE
    crop_ifs: bool = True
    imlib: Enum = Imlib.VIPFFT
    imlib2: Enum = Imlib.VIPFFT
    interpolation: Enum = Interpolation.LANCZOS4
    collapse: Enum = Collapse.MEDIAN
    collapse_ifs: Enum = Collapse.MEAN
    ifs_collapse_range: Union[str, Tuple[int]] = "all"
    smooth: float = None
    smooth_first_pass: float = None
    mask_rdi: object = None
    ref_strategy: str = "RDI"
    check_memory: bool = True
    batch: Union[int, float] = None
    nproc: int = 1
    full_output: bool = False
    verbose: bool = True
    weights: object = None
    left_eigv: bool = False
    min_frames_pca: int = 10
    max_frames_pca: int = None
    cube_sig: object = None
    med_of_npcs: bool = False


def _nbytes(a):
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else np.asarray(a).nbytes


def _value(v):
    """Plain string of an enum or string parameter."""
    return v.value if isinstance(v, Enum) else v


def pca(*all_args: List, **all_kwargs: dict):
    """Full-frame PCA PSF subtraction of a 3-d ADI cube, with an optional
    RDI/ARDI reference cube, or of a 4-d IFS cube (vip_tpu
    pca_fullfr.py:79).

    Returns the final frame, or with ``full_output`` (frame, pcs, recon,
    residuals_cube, residuals_cube_) — (frame, recon_cube, residuals_cube,
    residuals_cube_) with ``source_xy`` — as tensors on the cube's device.
    A grid ``ncomp`` returns the frames of the grid (their median with
    ``med_of_npcs``), or with ``source_xy`` the S/N-optimal frame; with
    ``full_output`` (frames, pclist), or (frames, frame, table) with
    ``source_xy`` (vip_tpu pca_fullfr.py:303-329). 4-d cubes return as
    vip_tpu's (:124-269): with ``scale_list`` the single pass gives the
    frame or (frame, cube_allfr_residuals, cube_desc_residuals,
    cube_adi_residuals), its grid what ``pca_grid`` gives, and the double
    pass the frame or (frame, res_cube_channels,
    residuals_cube_channels_); without, the channel-collapsed frame, and
    with ``full_output`` the per-channel results stacked beside the
    channel frames.
    """
    algo_params, rot_options = resolve_algo_params(
        PCA_Params, all_args, all_kwargs)
    p = algo_params

    if p.mask_center_px and len(rot_options) == 0:
        rot_options["mask_val"] = 0
        rot_options["ker"] = 1
        rot_options["interp_zeros"] = True

    start_time = time_ini(p.verbose)

    if p.left_eigv and (p.batch is not None or p.mask_rdi is not None
                        or p.cube_ref is not None):
        raise NotImplementedError(
            "left_eigv is not compatible with 'mask_rdi' nor 'batch'")
    if p.scale_list is not None:
        return _pca_adimsdi(p, start_time, rot_options)
    if getattr(p.cube, "ndim", None) == 4:
        return _pca_4d_channels(p, rot_options)
    if p.batch is not None:
        return _pca_batch(p, start_time, rot_options)
    check_array(p.cube, 3, msg="cube")
    _check_memory(p)

    if p.cube_ref is not None:
        if p.ref_strategy == "ARDI":
            cube = as_tensor(p.cube)
            p.cube_ref = torch.cat(
                (cube, as_tensor(p.cube_ref, cube.device, cube.dtype)))
        elif p.ref_strategy != "RDI":
            raise TypeError("ref_strategy argument not recognized. Should be "
                            "'RDI' or 'ARDI'")

    func_params = setup_parameters(params_obj=p, fkt=_adi_rdi_pca,
                                   start_time=start_time, full_output=True,
                                   grid_table=bool(p.full_output))
    res_pca = _adi_rdi_pca(**func_params, **rot_options)

    if isinstance(p.ncomp, (tuple, list)):
        if p.source_xy is not None:
            if p.full_output:
                final_residuals_cube, frame, table, _ = res_pca
                if p.med_of_npcs:
                    final_residuals_cube = _median_of_frames(
                        final_residuals_cube)
                return final_residuals_cube, frame, table
            return res_pca[1]
        final_residuals_cube, pclist = res_pca
        if p.med_of_npcs:
            final_residuals_cube = _median_of_frames(final_residuals_cube)
        if p.full_output:
            return final_residuals_cube, pclist
        return final_residuals_cube
    if p.source_xy is not None:
        recon_cube, residuals_cube, residuals_cube_, frame = res_pca
        if p.full_output:
            return frame, recon_cube, residuals_cube, residuals_cube_
        return frame
    pcs, recon, residuals_cube, residuals_cube_, frame = res_pca
    if p.full_output:
        return frame, pcs, recon, residuals_cube, residuals_cube_
    return frame


def _check_memory(p):
    input_bytes = _nbytes(p.cube_ref if p.cube_ref is not None else p.cube)
    check_enough_memory(
        input_bytes, 1.0, raise_error=p.check_memory,
        error_msg=(" Set check_memory=False to override this memory check"),
        verbose=p.verbose)


def _pca_adimsdi(p, start_time, rot_options):
    """``pca`` of a 4-d cube with ``scale_list``: the single or double
    ADI+mSDI pass (vip_tpu pca_fullfr.py:124-167)."""
    if getattr(p.cube, "ndim", None) != 4:
        raise ValueError("`scale_list` requires a 4D input cube")
    _check_memory(p)
    adimsdi = str(_value(p.adimsdi))
    add_params = {"start_time": start_time, "full_output": p.full_output}
    if p.cube_ref is not None:
        if p.cube_ref.ndim != 4:
            raise TypeError("Ref cube has wrong format for 4d input cube")
        if "A" in str(p.ref_strategy):
            add_params["ref_strategy"] = "ARSDI"
            if adimsdi == "single":
                cube = as_tensor(p.cube)
                add_params["cube_ref"] = torch.cat(
                    (cube, as_tensor(p.cube_ref, cube.device, cube.dtype)),
                    dim=1)
        else:
            add_params["ref_strategy"] = "RSDI"
    if adimsdi == "double":
        func_params = setup_parameters(params_obj=p, fkt=_adimsdi_doublepca,
                                       **add_params)
        res_cube_channels, residuals_cube_channels_, frame = \
            _adimsdi_doublepca(**func_params, **rot_options)
        if p.full_output:
            return frame, res_cube_channels, residuals_cube_channels_
        return frame
    if adimsdi == "single":
        func_params = setup_parameters(params_obj=p, fkt=_adimsdi_singlepca,
                                       **add_params)
        res_pca = _adimsdi_singlepca(**func_params, **rot_options)
        if np.isscalar(p.ncomp):
            (cube_allfr_residuals, cube_desc_residuals, cube_adi_residuals,
             frame) = res_pca
            if p.full_output:
                return (frame, cube_allfr_residuals, cube_desc_residuals,
                        cube_adi_residuals)
            return frame
        return res_pca
    raise ValueError("ADIMSDI value should be 'single' or 'double'.")


def _pca_4d_channels(p, rot_options):
    """``pca`` of a 4-d cube without ``scale_list``: a 3-d ``pca`` of each
    channel, then the channel frames collapse with ``collapse_ifs``
    (vip_tpu pca_fullfr.py:170-269)."""
    _check_memory(p)
    cube = as_tensor(p.cube)
    nch = cube.shape[0]
    collapse_ifs = str(_value(p.collapse_ifs))
    nc = p.ncomp
    if isinstance(nc, tuple):
        nc = list(nc)
    if not isinstance(nc, list) or len(nc) != nch:
        ncomp_ch = [nc] * nch
    else:
        ncomp_ch = nc
    grid_case = isinstance(ncomp_ch[0], (tuple, list))
    fwhm_ch = [p.fwhm] * nch if np.isscalar(p.fwhm) else p.fwhm
    cube_ref = None if p.cube_ref is None else as_tensor(
        p.cube_ref, cube.device, cube.dtype)

    chans = []
    for ch in range(nch):
        ref_ch = None
        if cube_ref is not None:
            if cube_ref[ch].ndim != 3:
                raise TypeError("Ref cube has wrong format for 4d input cube")
            if p.ref_strategy == "RDI":
                ref_ch = cube_ref[ch]
            elif p.ref_strategy == "ARDI":
                ref_ch = torch.cat((cube[ch], cube_ref[ch]))
            else:
                raise TypeError("ref_strategy argument not recognized. "
                                "Should be 'RDI' or 'ARDI'")
        chans.append(pca(
            cube[ch], p.angle_list, cube_ref=ref_ch, ncomp=ncomp_ch[ch],
            svd_mode=p.svd_mode, scaling=p.scaling,
            mask_center_px=p.mask_center_px, source_xy=p.source_xy,
            delta_rot=p.delta_rot, fwhm=fwhm_ch[ch], imlib=p.imlib,
            interpolation=p.interpolation, collapse=p.collapse,
            weights=p.weights, verbose=False, full_output=True,
            **rot_options))
    # per-channel results stack; channels whose ncomp differ keep a list
    # of their PCs (vip_tpu's numpy stack of them raises)
    parts = [torch.stack(x) if isinstance(x[0], torch.Tensor) and
             len({tuple(t.shape) for t in x}) == 1 else list(x)
             for x in zip(*chans)]
    src = p.source_xy is not None
    if grid_case and not src:
        ifs_adi_frames = parts[0]               # (nch, k, y, x)
        final_residuals_cube = torch.stack([
            cube_collapse(ifs_adi_frames[:, i], mode=collapse_ifs)
            for i in range(ifs_adi_frames.shape[1])])
    else:
        ifs_adi_frames = parts[1] if grid_case else parts[0]
        final_residuals_cube = parts[0] if grid_case else None
        frame = cube_collapse(ifs_adi_frames, mode=collapse_ifs)
    if final_residuals_cube is not None and p.med_of_npcs:
        final_residuals_cube = _median_of_frames(final_residuals_cube)

    if p.full_output and not src:
        if grid_case:
            return final_residuals_cube, parts[1], ifs_adi_frames
        return (frame, parts[1], parts[2], parts[3], parts[4],
                ifs_adi_frames)
    if p.full_output:
        if grid_case:
            return final_residuals_cube, frame, parts[2], ifs_adi_frames
        return frame, parts[1], parts[2], parts[3], ifs_adi_frames
    return final_residuals_cube if grid_case and not src else frame


def _pca_batch(p, start_time, rot_options):
    """``pca(batch=...)``: the streamed ``utils_pca.pca_incremental``
    (vip_tpu pca_fullfr.py:271-287). Returns its numpy frame, or (frame,
    pcs, medians) with ``full_output``."""
    from .utils_pca import pca_incremental

    if not isinstance(p.cube, (str, np.ndarray, torch.Tensor)):
        raise TypeError("`cube` must be a numpy (3d or 4d) array or a str "
                        "with the full path on disk")
    if not isinstance(p.cube, str):
        check_enough_memory(
            _nbytes(p.cube), 1.0, raise_error=p.check_memory,
            error_msg=(" Set check_memory=False to override this memory "
                       "check or set `batch` to run incremental PCA"),
            verbose=p.verbose)
    if p.cube_ref is not None:
        raise ValueError("RDI not compatible with batch mode")
    res_inc = pca_incremental(
        p.cube, p.angle_list, batch=p.batch, ncomp=p.ncomp,
        collapse=p.collapse, verbose=p.verbose, full_output=p.full_output,
        start_time=start_time, weights=p.weights, nproc=p.nproc,
        imlib=p.imlib, interpolation=p.interpolation, **rot_options)
    if p.full_output:
        frame, _, pcs, medians = res_inc
        return frame, pcs, medians
    return res_inc


def _median_of_frames(frames):
    """``numpy.median`` of a (k, y, x) stack over its first axis: H1 with
    NaN propagation on the card, its plain version otherwise."""
    from ..ops.median import (nanmedian_axis0, nanmedian_plain,
                              nanmedian_supported)

    if nanmedian_supported(frames, 0):
        return nanmedian_axis0(frames.contiguous(), propagate=True)
    return nanmedian_plain(frames, 0, propagate=True)


def _adi_rdi_pca(cube, cube_ref, angle_list, ncomp, source_xy, delta_rot,
                 fwhm, scaling, mask_center_px, svd_mode, imlib,
                 interpolation, collapse, verbose, start_time, nproc,
                 full_output, weights=None, mask_rdi=None, cube_sig=None,
                 left_eigv=False, min_frames_pca=10, max_frames_pca=None,
                 smooth=None, grid_table=True, **rot_options):
    """ADI/RDI full-frame PCA core (vip_tpu pca_fullfr.py:332-445). A grid
    ``ncomp`` goes to ``pca_grid`` (its pandas table only with
    ``grid_table``); ``smooth`` is the FWHM of a Gaussian low-pass of the
    final frame."""
    if isinstance(ncomp, (tuple, list)):
        from .utils_pca import _pca_grid

        return _pca_grid(
            cube, angle_list, fwhm, ncomp, source_xy, cube_ref, "fullfr", 20,
            svd_mode, scaling, mask_center_px, "mean", collapse, verbose,
            full_output, False, True, None, start_time, None, weights, False,
            grid_table, dict(nproc=nproc, imlib=_value(imlib),
                             interpolation=_value(interpolation),
                             **rot_options))
    cube = as_tensor(cube)
    if cube_ref is not None:
        cube_ref = as_tensor(cube_ref, cube.device, cube.dtype)
    n, y, x = cube.shape
    angle_list = check_pa_vector(angle_list)
    if not n == angle_list.shape[0]:
        raise ValueError("`angle_list` vector has wrong length. It must equal "
                         "the number of frames in the cube")
    if not np.isscalar(ncomp):
        raise TypeError("`ncomp` must be an int, float, tuple or list in the "
                        "ADI case")

    nref = cube_ref.shape[0] if cube_ref is not None else n
    if isinstance(ncomp, (int, np.integer)) and ncomp > nref:
        ncomp = min(int(ncomp), nref)
        print(f"Number of PCs too high (max PCs={nref}), using {ncomp} PCs "
              "instead.")
    elif ncomp <= 0:
        raise ValueError("Number of PCs too low. It should be > 0.")

    if mask_rdi is not None:
        from ..preproc.skysubtraction import cube_subtract_sky_pca

        residuals_cube, _, pcs, recon = cube_subtract_sky_pca(
            cube, cube_ref, mask_rdi, ncomp=ncomp, full_output=True)
        recon_cube = None
    elif source_xy is None:
        residuals_cube, reconstructed, V = _project_subtract(
            cube, cube_ref, ncomp, scaling, mask_center_px, svd_mode,
            verbose, True, cube_sig=cube_sig, left_eigv=left_eigv)
        if verbose:
            timing(start_time)
        pcs = V.reshape(-1, y, x) if not left_eigv else V.T
        recon = reconstructed.reshape(-1, y, x)
    else:
        # rotation-threshold path: one library per frame, chosen on the
        # host from the parallactic angles
        if delta_rot is None or fwhm is None:
            raise TypeError("Delta_rot or fwhm parameters missing. Needed for"
                            "PA-based rejection of frames from the library")
        nfrslib = []
        residuals_cube = torch.zeros_like(cube)
        recon_cube = torch.zeros_like(cube)
        yc, xc = frame_center(cube[0], False)
        x1, y1 = source_xy
        pa_thr = _compute_pa_thresh(dist(yc, xc, y1, x1), fwhm, delta_rot)
        truncate = max_frames_pca is not None
        for frame in range(n):
            ind = _find_indices_adi(angle_list, frame, pa_thr,
                                    truncate=truncate,
                                    max_frames=max_frames_pca)
            res_result = _project_subtract(
                cube, cube_ref, ncomp, scaling, mask_center_px, svd_mode,
                verbose, True, ind, frame, cube_sig=cube_sig,
                left_eigv=left_eigv, min_frames_pca=min_frames_pca)
            nfrslib.append(res_result[0])
            residuals_cube[frame] = res_result[1].reshape(y, x)
            recon_cube[frame] = res_result[2].reshape(y, x)
        if verbose:
            print(f"Size LIB: min={min(nfrslib)}, max={max(nfrslib)}, "
                  f"mean={np.mean(nfrslib):.1f}")

    residuals_cube_ = cube_derotate(residuals_cube, angle_list, nproc=nproc,
                                    imlib=_value(imlib),
                                    interpolation=_value(interpolation),
                                    **rot_options)
    frame = cube_collapse(residuals_cube_, mode=_value(collapse), w=weights)
    if smooth is not None:
        from ..var.filters import frame_filter_lowpass

        frame = frame_filter_lowpass(frame, mode="gauss", fwhm_size=smooth)
    if mask_center_px:
        residuals_cube_ = mask_circle(residuals_cube_, mask_center_px)
        frame = mask_circle(frame, mask_center_px)
    if verbose:
        print("Done de-rotating and combining")
        timing(start_time)

    if source_xy is not None:
        return recon_cube, residuals_cube, residuals_cube_, frame
    return pcs, recon, residuals_cube, residuals_cube_, frame


def _project_subtract(cube, cube_ref, ncomp, scaling, mask_center_px,
                      svd_mode, verbose, full_output, indices=None,
                      frame=None, cube_sig=None, left_eigv=False,
                      min_frames_pca=10):
    """PCA projection + model-PSF subtraction (vip_tpu
    pca_fullfr.py:734-861): the whole matrix at once, or one frame against
    its PA-selected library when ``indices`` and ``frame`` are given. A
    float ``ncomp`` in (0, 1) is a cumulative explained variance ratio
    (``SVDecomposer``); ``left_eigv`` projects on the left singular
    vectors (the whole-matrix branch drops the masked center pixels)."""
    n, y, x = cube.shape
    if not isinstance(ncomp, (int, np.integer, float, np.floating)):
        raise TypeError("Type not recognized for ncomp, should be int or "
                        "float")
    scaling = _value(scaling)
    mode = str(_value(svd_mode))
    if isinstance(ncomp, (float, np.floating)):
        if not 1 > ncomp > 0:
            raise ValueError("if `ncomp` is float, it must lie in the "
                             "interval (0,1]")
        svdecomp = SVDecomposer(cube, mode="fullfr", svd_mode=mode,
                                scaling=scaling, verbose=verbose)
        ncomp = svdecomp.cevr_to_ncomp(ncomp)
        if verbose:
            print(f"Components used : {ncomp}")
    ncomp = int(ncomp)
    method = MODE_TO_METHOD.get(mode)
    if method is None:
        raise ValueError("The SVD `mode` is not recognized")

    discard = bool(left_eigv) and indices is None and frame is None
    matrix = prepare_matrix(cube, scaling, mask_center_px, mode="fullfr",
                            verbose=verbose and indices is None,
                            discard_mask_pix=discard)
    matrix_sig = None
    if cube_sig is not None:
        if discard:
            matrix_sig = prepare_matrix(cube_sig, scaling, mask_center_px,
                                        mode="fullfr", verbose=False,
                                        discard_mask_pix=True)
        else:
            matrix_sig = as_tensor(cube_sig, matrix.device,
                                   matrix.dtype).reshape(n, -1)
    matrix_emp = matrix if matrix_sig is None else matrix - matrix_sig
    matrix_ref = None
    if cube_ref is not None:
        matrix_ref = prepare_matrix(cube_ref, scaling, mask_center_px,
                                    mode="fullfr", verbose=False,
                                    discard_mask_pix=discard)

    if indices is not None and frame is not None:
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=matrix.device)
        ref_lib = matrix_emp[idx]
        if cube_ref is not None:
            ref_lib = torch.cat((ref_lib, matrix_ref))
        if ref_lib.shape[0] < min_frames_pca:
            raise RuntimeError(
                f"{ref_lib.shape[0]} frames comply to delta_rot condition < "
                f"less than min_frames_pca ({min_frames_pca}). Try decreasing"
                f" delta_rot or min_frames_pca")
        if ref_lib.shape[0] < ncomp:
            raise RuntimeError(
                f"{ref_lib.shape[0]} frames comply to delta_rot condition < "
                f"less than ncomp ({ncomp}). Try decreasing the parameter "
                f"delta_rot or ncomp")
        if left_eigv:
            V = svd_wrapper(ref_lib, mode, ncomp, False, to_numpy=False,
                            left_eigv=True)
            reconstructed = V @ (matrix_emp[frame] @ V).T
        else:
            V = svd_top(ref_lib, ncomp, method=method)
            reconstructed = (matrix_emp[frame] @ V.T) @ V
        residuals = matrix[frame] - reconstructed
        if full_output:
            return ref_lib.shape[0], residuals, reconstructed
        return ref_lib.shape[0], residuals

    if left_eigv:
        ref_lib = matrix_emp if matrix_ref is None else matrix_ref
        V = svd_wrapper(ref_lib, mode, ncomp, verbose, to_numpy=False,
                        left_eigv=True)
        reconstructed = V @ (matrix_emp.T @ V).T
        residuals = (matrix - reconstructed).reshape(n, y, x)
        if full_output:
            return residuals, reconstructed, V
        return residuals

    residuals, reconstructed, V = project_subtract(
        matrix, matrix_ref, ncomp, method=method, matrix_sig=matrix_sig,
        full_output=True)
    residuals = residuals.reshape(n, y, x)
    if full_output:
        return residuals, reconstructed, V
    return residuals


def _collapse_range(ifs_collapse_range, z):
    if ifs_collapse_range == "all":
        return 0, z
    return ifs_collapse_range


def _adimsdi_singlepca(cube, cube_ref, angle_list, scale_list, ncomp, fwhm,
                       source_xy, scaling, mask_center_px, svd_mode, imlib,
                       imlib2, interpolation, collapse, collapse_ifs,
                       ifs_collapse_range, verbose, start_time, nproc,
                       crop_ifs, batch, full_output, weights=None,
                       left_eigv=False, min_frames_pca=10,
                       ref_strategy="RSDI", **rot_options):
    """Single-pass ADI+mSDI PCA (vip_tpu pca_fullfr.py:448): every channel
    rescaled to align the speckles (one batched zoom a channel over all
    frames), one PCA of the z·n frames, each frame's channels rescaled
    back and collapsed (one median over all frames), derotated and
    collapsed. A grid ``ncomp`` goes to ``pca_grid`` with the 4-d shape.
    Returns (cube_allfr_residuals (n·z, Y, X), cube_desc_residuals (z, n,
    y, x), cube_adi_residuals (n, y, x), frame)."""
    cube = as_tensor(cube)
    z, n, y_in, x_in = cube.shape
    angle_list = check_pa_vector(angle_list)
    if not angle_list.shape[0] == n:
        raise ValueError("Angle list vector has wrong length. It must equal "
                         "the number frames in the cube")
    if scale_list is None:
        raise ValueError("`scale_list` must be provided")
    scale_list = _host_vec(scale_list)
    if not scale_list.shape[0] == z:
        raise ValueError("`scale_list` has wrong length")
    imlib2 = _value(imlib2)

    def _rescaled_stack(c4):
        zz, nn = c4.shape[:2]
        big = _scwave(c4, scale_list, imlib=imlib2,
                      interpolation=_value(interpolation), collapse=None)[0]
        if crop_ifs:
            big = cube_crop_frames(big, size=y_in, verbose=False)
        return big.transpose(0, 1).reshape(nn * zz, *big.shape[-2:])

    if verbose:
        print("Rescaling the spectral channels to align the speckles")
    big_cube = _rescaled_stack(cube)
    big_cube_ref = None
    if cube_ref is not None:
        big_cube_ref = _rescaled_stack(as_tensor(cube_ref, cube.device,
                                                 cube.dtype))
    if verbose:
        timing(start_time)
        print(f"{n * z} total frames")
        print("Performing single-pass PCA")

    if isinstance(ncomp, (tuple, list)):
        from .utils_pca import _pca_grid

        return _pca_grid(
            big_cube, angle_list, fwhm, ncomp, source_xy, None, "fullfr", 20,
            svd_mode, scaling, mask_center_px, "mean", collapse, verbose,
            full_output, False, True, None, start_time, scale_list, weights,
            False, True, dict(nproc=nproc, imlib=_value(imlib),
                              interpolation=_value(interpolation),
                              **rot_options),
            ifs_collapse_range=ifs_collapse_range,
            initial_4dshape=tuple(cube.shape))
    if not np.isscalar(ncomp):
        raise TypeError("`ncomp` must be an int, float, tuple or list for "
                        "single-pass PCA")
    res_cube = _project_subtract(big_cube, big_cube_ref, ncomp, scaling,
                                 mask_center_px, svd_mode, verbose, False,
                                 left_eigv=left_eigv,
                                 min_frames_pca=min_frames_pca)
    if verbose:
        timing(start_time)
    idx_ini, idx_fin = _collapse_range(ifs_collapse_range, z)
    res4 = res_cube.reshape(n, z, *res_cube.shape[-2:])[:, idx_ini:idx_fin]
    cube_desc_residuals, resadi_cube = _scwave(
        res4.transpose(0, 1), scale_list[idx_ini:idx_fin], inverse=True,
        y_in=y_in, x_in=x_in, imlib=imlib2,
        interpolation=_value(interpolation),
        collapse=_value(collapse_ifs))[:2]
    if verbose:
        print("De-rotating and combining residuals")
        timing(start_time)
    der_res = cube_derotate(resadi_cube, angle_list, nproc=nproc,
                            imlib=_value(imlib),
                            interpolation=_value(interpolation),
                            **rot_options)
    if mask_center_px:
        der_res = mask_circle(der_res, mask_center_px)
    frame = cube_collapse(der_res, mode=_value(collapse), w=weights)
    return res_cube, cube_desc_residuals, resadi_cube, frame


def _adimsdi_doublepca(cube, cube_ref, angle_list, scale_list, ncomp,
                       scaling, mask_center_px, svd_mode, imlib, imlib2,
                       interpolation, collapse, collapse_ifs,
                       ifs_collapse_range, verbose, start_time, nproc,
                       weights=None, fwhm=4, source_xy=None, delta_rot=None,
                       smooth_first_pass=None, min_frames_pca=10,
                       max_frames_pca=None, mask_rdi=None, cube_sig=None,
                       left_eigv=False, ref_strategy="RSDI", **rot_options):
    """Double-pass ADI+mSDI PCA (vip_tpu pca_fullfr.py:558): one spectral
    PCA a temporal frame (``_adimsdi_doublepca_ifs``, all frames at
    once), then a PCA in the ADI fashion of the channel-collapsed frames
    (skipped when its ncomp is None), derotation and collapse. Returns
    (res_cube_channels, residuals_cube_channels_, frame)."""
    cube = as_tensor(cube)
    z, n, y_in, x_in = cube.shape
    if cube_ref is not None:
        cube_ref = as_tensor(cube_ref, cube.device, cube.dtype)
        cube = torch.cat((cube, cube_ref), dim=1)
        nr = cube_ref.shape[1]
    else:
        nr = 0
    if not isinstance(ncomp, tuple):
        raise TypeError("`ncomp` must be a tuple when a double pass PCA is "
                        "performed")
    ncomp_ifs, ncomp_adi = ncomp
    angle_list = check_pa_vector(angle_list)
    if not angle_list.shape[0] == n:
        raise ValueError("Angle list vector has wrong length. It must equal "
                         "the number frames in the cube")
    if scale_list is None:
        raise ValueError("Scaling factors vector must be provided")
    scale_list = _host_vec(scale_list)
    if scale_list.ndim > 1:
        raise ValueError("Scaling factors vector is not 1d")
    if not scale_list.shape[0] == cube.shape[0]:
        raise ValueError("Scaling factors vector has wrong length")
    if type(scaling) is not tuple:
        scaling = (scaling, scaling)
    if verbose:
        print(f"{z} spectral channels in IFS cube")
        if ncomp_ifs is None:
            print("Combining multi-spectral frames (skipping PCA)")
        else:
            print("First PCA stage exploiting spectral variability")
    if ncomp_ifs is not None and ncomp_ifs > z:
        ncomp_ifs = min(ncomp_ifs, z)
        print(f"Number of PCs too high (max PCs={z}), using {ncomp_ifs} PCs "
              "instead")

    res_cube_channels = _adimsdi_doublepca_ifs(
        cube, None, ncomp_ifs, scale_list, scaling[0], mask_center_px,
        svd_mode, imlib2, interpolation, collapse_ifs, ifs_collapse_range,
        fwhm, mask_rdi, left_eigv)
    if verbose:
        timing(start_time)
    if smooth_first_pass is not None:
        from ..var.filters import cube_filter_lowpass

        res_cube_channels = cube_filter_lowpass(
            res_cube_channels, mode="gauss", fwhm_size=smooth_first_pass,
            verbose=False)

    rot = dict(nproc=nproc, imlib=_value(imlib),
               interpolation=_value(interpolation), **rot_options)
    if ncomp_adi is None:
        if verbose:
            print(f"{n} ADI frames")
            print("De-rotating and combining frames (skipping PCA)")
        residuals_cube_channels_ = cube_derotate(res_cube_channels[:n],
                                                 angle_list, **rot)
        frame = cube_collapse(residuals_cube_channels_, mode=_value(collapse),
                              w=weights)
        return res_cube_channels, residuals_cube_channels_, frame

    if ncomp_adi > n + nr:
        ncomp_adi = n + nr
        print(f"Number of PCs too high, using maximum of {n} PCs instead")
    if verbose:
        print(f"{n} ADI frames")
        print("Second PCA stage exploiting rotational variability")
    if source_xy is None:
        if "A" in ref_strategy or nr == 0:
            res_ifs_adi = _project_subtract(
                res_cube_channels, None, ncomp_adi, scaling[1],
                mask_center_px, svd_mode, verbose, False, cube_sig=cube_sig,
                left_eigv=left_eigv)
        else:
            res_ifs_adi = _project_subtract(
                res_cube_channels[:n], res_cube_channels[n:], ncomp_adi,
                scaling[1], mask_center_px, svd_mode, verbose, False,
                cube_sig=cube_sig, left_eigv=left_eigv)
    else:
        if delta_rot is None or fwhm is None:
            raise TypeError("Delta_rot or fwhm parameters missing. Needed for"
                            " PA-based rejection of frames from the library")
        yc, xc = frame_center(cube[0, 0], False)
        x1, y1 = source_xy
        pa_thr = _compute_pa_thresh(dist(yc, xc, y1, x1), fwhm, delta_rot)
        res_ifs_adi = res_cube_channels.new_zeros((n, y_in, x_in))
        truncate = max_frames_pca is not None
        for fr in range(n):
            ind = _find_indices_adi(angle_list, fr, pa_thr,
                                    truncate=truncate,
                                    max_frames=max_frames_pca)
            res_result = _project_subtract(
                res_cube_channels[:n],
                res_cube_channels[n:] if nr else None, ncomp_adi,
                scaling[1], mask_center_px, svd_mode, verbose, False, ind,
                fr, cube_sig=cube_sig, left_eigv=left_eigv,
                min_frames_pca=min_frames_pca)
            res_ifs_adi[fr] = res_result[-1].reshape(y_in, x_in)
    if verbose:
        print("De-rotating and combining residuals")
    residuals_cube_channels_ = cube_derotate(res_ifs_adi[:n], angle_list,
                                             **rot)
    frame = cube_collapse(residuals_cube_channels_, mode=_value(collapse),
                          w=weights)
    if verbose:
        timing(start_time)
    return res_cube_channels, residuals_cube_channels_, frame


def _adimsdi_doublepca_ifs(array, fr, ncomp, scale_list, scaling,
                           mask_center_px, svd_mode, imlib, interpolation,
                           collapse, ifs_collapse_range, fwhm, mask_rdi=None,
                           left_eigv=False):
    """The spectral PCA of the temporal frames ``fr`` (indices, or None
    for all) of a (z, n, y, x) cube (vip_tpu pca_fullfr.py:691, one frame
    there): the channels of all frames rescaled in one batched zoom a
    channel, the frames' PCAs in one batched ``svd_top`` (int ``ncomp``
    without ``left_eigv`` or ``mask_rdi``), rescaled back and their
    channels collapsed at once. Returns (len(fr), y, x)."""
    array = as_tensor(array)
    if fr is not None:
        array = array[:, fr]
    z, N, y_in, x_in = array.shape
    idx_ini, idx_fin = _collapse_range(ifs_collapse_range, z)
    if ncomp is None:
        sub = array[idx_ini:idx_fin]
        return cube_collapse(sub.reshape(sub.shape[0], N * y_in, x_in),
                             mode="median").reshape(N, y_in, x_in)
    scale_list = _host_vec(scale_list)
    imlib = _value(imlib)
    interpolation = _value(interpolation)
    resc = _scwave(array, scale_list, imlib=imlib,
                   interpolation=interpolation, collapse=None)[0]
    Y, X = resc.shape[-2:]
    resc = resc.transpose(0, 1)                     # (N, z, Y, X)
    scaling = _value(scaling)
    mode = str(_value(svd_mode))
    if mask_rdi is not None:
        from ..preproc.skysubtraction import cube_subtract_sky_pca

        residuals = torch.empty_like(resc)
        for f in range(N):
            for i in range(z):
                others = [j for j in range(z) if j != i]
                residuals[f, i] = cube_subtract_sky_pca(
                    resc[f, i:i + 1], resc[f, others], mask_rdi,
                    ncomp=ncomp, full_output=False)[0]
    elif left_eigv or not isinstance(ncomp, (int, np.integer)):
        residuals = torch.stack([_project_subtract(
            resc[f], None, ncomp, scaling, mask_center_px, mode, False,
            False, left_eigv=left_eigv) for f in range(N)])
    else:
        method = MODE_TO_METHOD.get(mode)
        if method is None:
            raise ValueError("The SVD `mode` is not recognized")
        arr = mask_circle(resc, mask_center_px) if mask_center_px else resc
        matrix = matrix_scaling_jax(arr.reshape(N, z, Y * X), scaling)
        del arr
        V = svd_top(matrix, int(ncomp), method=method)
        residuals = (matrix - (matrix @ V.mT) @ V).reshape(N, z, Y, X)
        del matrix
    del resc
    frames = _scwave(residuals[:, idx_ini:idx_fin].transpose(0, 1),
                     scale_list[idx_ini:idx_fin], inverse=True, y_in=y_in,
                     x_in=x_in, imlib=imlib, interpolation=interpolation,
                     collapse=_value(collapse), keep_cube=False)[1]
    if mask_center_px:
        frames = mask_circle(frames, mask_center_px)
    return frames

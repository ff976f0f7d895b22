"""Full-frame PCA for ADI / RDI / ARDI 3-d cubes (port of
``vip_tpu.psfsub.pca_fullfr``).

Same public surface as vip_tpu's ``pca(*args, **kwargs)``: the
dataclass-params convention, keyword arguments outside ``PCA_Params``
passed on as ``rot_options``, and the same return tuples. The pipeline
prepare-matrix → SVD → project/subtract → derotate (CUDA kernel H2) →
collapse (CUDA kernel H1) runs on the cube's device; results are tensors
there.

Not ported yet (each raises ``NotImplementedError``; ROADMAP.md Queue 1,
"pca paths still to port"): 4-D/SDI cubes and ``scale_list``, ``batch``
(incremental PCA), a ``ncomp`` grid (tuple or list), a float ``ncomp``
(CEVR), ``left_eigv``, ``mask_rdi`` and ``smooth``.
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
from ..ops.linalg import project_subtract, svd_top
from ..preproc.derotation import (_compute_pa_thresh, _find_indices_adi,
                                  cube_derotate)
from ..preproc.parangles import check_pa_vector
from ..preproc.subsampling import cube_collapse
from ..var.coords import dist, frame_center
from ..var.shapes import mask_circle, prepare_matrix
from .svd import MODE_TO_METHOD

__all__ = ["pca", "PCA_Params"]

_WAITS = ("is not ported yet (ROADMAP.md, Queue 1: 'pca paths still to "
          "port')")


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
    RDI/ARDI reference cube (vip_tpu pca_fullfr.py:79).

    Returns the final frame, or with ``full_output`` (frame, pcs, recon,
    residuals_cube, residuals_cube_) — (frame, recon_cube, residuals_cube,
    residuals_cube_) with ``source_xy`` — as tensors on the cube's device.
    """
    algo_params, rot_options = resolve_algo_params(
        PCA_Params, all_args, all_kwargs)
    p = algo_params

    if p.mask_center_px and len(rot_options) == 0:
        rot_options["mask_val"] = 0
        rot_options["ker"] = 1
        rot_options["interp_zeros"] = True

    start_time = time_ini(p.verbose)

    for what, waits in (("scale_list (4-d/SDI)", p.scale_list is not None),
                        ("batch (incremental PCA)", p.batch is not None),
                        ("a ncomp grid", isinstance(p.ncomp, (tuple, list))),
                        ("a float ncomp (CEVR)",
                         isinstance(p.ncomp, (float, np.floating))),
                        ("left_eigv", bool(p.left_eigv)),
                        ("mask_rdi", p.mask_rdi is not None),
                        ("smooth", p.smooth is not None)):
        if waits:
            raise NotImplementedError(f"pca: {what} {_WAITS}")
    if getattr(p.cube, "ndim", None) == 4:
        raise NotImplementedError(f"pca: 4-d cubes {_WAITS}")
    check_array(p.cube, 3, msg="cube")

    input_bytes = _nbytes(p.cube_ref if p.cube_ref is not None else p.cube)
    check_enough_memory(
        input_bytes, 1.0, raise_error=p.check_memory,
        error_msg=(" Set check_memory=False to override this memory check"),
        verbose=p.verbose)

    if p.cube_ref is not None:
        if p.ref_strategy == "ARDI":
            cube = as_tensor(p.cube)
            p.cube_ref = torch.cat(
                (cube, as_tensor(p.cube_ref, cube.device, cube.dtype)))
        elif p.ref_strategy != "RDI":
            raise TypeError("ref_strategy argument not recognized. Should be "
                            "'RDI' or 'ARDI'")

    func_params = setup_parameters(params_obj=p, fkt=_adi_rdi_pca,
                                   start_time=start_time, full_output=True)
    res_pca = _adi_rdi_pca(**func_params, **rot_options)

    if p.source_xy is not None:
        recon_cube, residuals_cube, residuals_cube_, frame = res_pca
        if p.full_output:
            return frame, recon_cube, residuals_cube, residuals_cube_
        return frame
    pcs, recon, residuals_cube, residuals_cube_, frame = res_pca
    if p.full_output:
        return frame, pcs, recon, residuals_cube, residuals_cube_
    return frame


def _adi_rdi_pca(cube, cube_ref, angle_list, ncomp, source_xy, delta_rot,
                 fwhm, scaling, mask_center_px, svd_mode, imlib,
                 interpolation, collapse, verbose, start_time, nproc,
                 full_output, weights=None, cube_sig=None,
                 min_frames_pca=10, max_frames_pca=None, **rot_options):
    """ADI/RDI full-frame PCA core (vip_tpu pca_fullfr.py:332-445)."""
    cube = as_tensor(cube)
    if cube_ref is not None:
        cube_ref = as_tensor(cube_ref, cube.device, cube.dtype)
    n, y, x = cube.shape
    angle_list = check_pa_vector(angle_list)
    if not n == angle_list.shape[0]:
        raise ValueError("`angle_list` vector has wrong length. It must equal "
                         "the number of frames in the cube")
    if not np.isscalar(ncomp):
        raise TypeError("`ncomp` must be an int in the ADI case")

    nref = cube_ref.shape[0] if cube_ref is not None else n
    if isinstance(ncomp, (int, np.integer)) and ncomp > nref:
        ncomp = min(int(ncomp), nref)
        print(f"Number of PCs too high (max PCs={nref}), using {ncomp} PCs "
              "instead.")
    elif ncomp <= 0:
        raise ValueError("Number of PCs too low. It should be > 0.")

    if source_xy is None:
        residuals_cube, reconstructed, V = _project_subtract(
            cube, cube_ref, ncomp, scaling, mask_center_px, svd_mode,
            verbose, True, cube_sig=cube_sig)
        if verbose:
            timing(start_time)
        pcs = V.reshape(-1, y, x)
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
                min_frames_pca=min_frames_pca)
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
                      frame=None, cube_sig=None, min_frames_pca=10):
    """PCA projection + model-PSF subtraction (vip_tpu
    pca_fullfr.py:734-861, without ``left_eigv`` and CEVR): the whole
    matrix at once, or one frame against its PA-selected library when
    ``indices`` and ``frame`` are given."""
    n, y, x = cube.shape
    if not isinstance(ncomp, (int, np.integer)):
        raise TypeError("Type not recognized for ncomp, should be int")
    ncomp = int(ncomp)
    method = MODE_TO_METHOD.get(str(_value(svd_mode)))
    if method is None:
        raise ValueError("The SVD `mode` is not recognized")
    scaling = _value(scaling)

    matrix = prepare_matrix(cube, scaling, mask_center_px, mode="fullfr",
                            verbose=verbose and indices is None)
    matrix_sig = None
    if cube_sig is not None:
        matrix_sig = as_tensor(cube_sig, matrix.device,
                               matrix.dtype).reshape(n, -1)
    matrix_emp = matrix if matrix_sig is None else matrix - matrix_sig
    matrix_ref = None
    if cube_ref is not None:
        matrix_ref = prepare_matrix(cube_ref, scaling, mask_center_px,
                                    mode="fullfr", verbose=False)

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
        V = svd_top(ref_lib, ncomp, method=method)
        reconstructed = (matrix_emp[frame] @ V.T) @ V
        residuals = matrix[frame] - reconstructed
        if full_output:
            return ref_lib.shape[0], residuals, reconstructed
        return ref_lib.shape[0], residuals

    residuals, reconstructed, V = project_subtract(
        matrix, matrix_ref, ncomp, method=method, matrix_sig=matrix_sig,
        full_output=True)
    residuals = residuals.reshape(n, y, x)
    if full_output:
        return residuals, reconstructed, V
    return residuals

"""PCA helpers: the grid over the number of PCs, single-annulus PCA and
the streamed (out-of-core) PCA for 3-d cubes (port of
``vip_tpu.psfsub.utils_pca``: ``pca_grid``, ``pca_annulus``,
``pca_incremental``).

``pca_grid`` keeps VIP's SVD-once, truncate-many design: one SVD of the
library at the largest ``ncomp``, then each truncation's residual cube is
built from the shared basis, derotated and collapsed on the cube's
device. The exact rotation does not depend on how frames are chunked, so
the exact route builds, derotates and collapses one truncation at a time
(one residual cube in memory, not k); the fft-small route stacks the k
residual cubes, because its packed CPU rotation pairs frames across the
stack as vip_tpu does. pandas is imported only when a table is returned,
matplotlib only when ``plot`` is set. With ``scale_list`` and
``initial_4dshape`` (the single ADI+mSDI pass) each truncation's z·n
residual frames are rescaled back and their channels collapsed before
the derotation; ``pca_annulus`` reduces a 4-d cube channel by channel.

``pca_incremental`` streams a cube (a FITS path, a lazy HDU, an array or
a tensor) in batches: pass 1 merges each batch into a truncated SVD (the
Gram-eigh merge of vip_tpu), pass 2 projects each batch, derotates and
collapses it on the card (CUDA kernels H2 and H1), and the final frame is
the host median of the per-batch frames.
"""

import concurrent.futures
import math
from enum import Enum

import numpy as np
import torch

from ..config import time_ini, timing
from ..config.device import as_tensor, get_device
from ..preproc.derotation import _auto_chunk, cube_derotate
from ..preproc.subsampling import collapse_jax, cube_collapse
from ..var.coords import dist, frame_center
from ..var.shapes import disk_coords, prepare_matrix
from .svd import svd_wrapper

__all__ = ["pca_grid", "pca_annulus", "pca_incremental"]

# pca_incremental keeps the pass-1 blocks on the card when the whole cube
# takes at most this fraction of its free memory (vip_tpu's budget: pass
# 2's padded rotation canvases need the rest)
_CACHE_FRACTION = 0.25


def _value(v):
    return v.value if isinstance(v, Enum) else v


def _residual_cube(matrix, V, pc, shape, annind):
    """Residuals of ``matrix`` after the projection on the first ``pc``
    rows of ``V``, as an (n, y, x) cube (zeros outside the annulus)."""
    Vk = V[:pc]
    res = matrix - (Vk @ matrix.T).T @ Vk
    if annind is None:
        return res.reshape(shape)
    cube = res.new_zeros(shape)
    cube[:, torch.as_tensor(annind[0], device=res.device),
         torch.as_tensor(annind[1], device=res.device)] = res
    return cube


def _grid_frames(matrix, V, pclist, shape, annind, angle_list, derotate,
                 collapse_fn, stacked):
    """One final frame per truncation: residual cube → ``derotate`` →
    ``collapse_fn``. ``stacked``: derotate the k cubes as one (k·n)-frame
    cube with the angles tiled, else one truncation at a time."""
    k = len(pclist)
    n = shape[0]
    angles = np.asarray(angle_list, dtype=float)
    if not stacked:
        return [collapse_fn(derotate(
            _residual_cube(matrix, V, pc, shape, annind), angles))
            for pc in pclist]
    stack = torch.cat([_residual_cube(matrix, V, pc, shape, annind)
                       for pc in pclist])
    der = derotate(stack, np.tile(angles, k)).reshape(k, *shape)
    return [collapse_fn(der[i]) for i in range(k)]


def _snr_of(frame, y, x, fwhm, fmerit, exclude_negative_lobes):
    """S/N figure of merit of one frame at (y, x) (vip_tpu
    utils_pca.py:113): 'px' at the pixel, 'max' or 'mean' over the test
    disk of diameter fwhm, all positions in one batched photometry."""
    from ..metrics.snr_source import snr_multi

    if fmerit == "px":
        snr_pixels, fluxes = snr_multi(
            frame, [x], [y], fwhm,
            exclude_negative_lobes=exclude_negative_lobes)
        return snr_pixels[0], fluxes[0]
    yy, xx = disk_coords((y, x), fwhm / 2.0,
                         (frame.shape[0], frame.shape[1]))
    snr_pixels, fluxes = snr_multi(
        frame, xx, yy, fwhm, exclude_negative_lobes=exclude_negative_lobes)
    if fmerit == "max":
        argm = np.argmax(snr_pixels)
        return np.max(snr_pixels), fluxes[argm]
    return np.mean(snr_pixels), np.mean(fluxes)


def pca_grid(cube, angle_list, fwhm=None, range_pcs=None, source_xy=None,
             cube_ref=None, mode="fullfr", annulus_width=20,
             svd_mode="lapack", scaling=None, mask_center_px=None,
             fmerit="mean", collapse="median", ifs_collapse_range="all",
             verbose=True, full_output=False, debug=False, plot=True,
             save_plot=None, start_time=None, scale_list=None,
             initial_4dshape=None, weights=None,
             exclude_negative_lobes=False, **rot_options):
    """Residual PCA frames over a range of numbers of PCs; with
    ``source_xy`` the S/N-optimal one (vip_tpu utils_pca.py:63). Same
    parameters and returns: (cubeout, finalfr, table, opt_npc) with a
    source, else cubeout or (cubeout, pclist) — frames as tensors on the
    cube's device.

    With ``imlib`` (or nothing) as the only rotation option, a finite
    cube, and collapse 'median', 'mean' or 'sum' (vip_tpu's device
    branch), each truncation is derotated by ``ops.pipeline``'s
    derotation and collapsed by ``collapse_jax`` (CUDA kernels H2 or H4,
    and H1, on the card); otherwise through ``cube_derotate`` and
    ``cube_collapse`` with the rotation options (vip_tpu's host branch,
    which ``pca(ncomp=tuple)`` takes). Both give the same frames.
    """
    return _pca_grid(cube, angle_list, fwhm, range_pcs, source_xy, cube_ref,
                     mode, annulus_width, svd_mode, scaling, mask_center_px,
                     fmerit, collapse, verbose, full_output, debug, plot,
                     save_plot, start_time, scale_list, weights,
                     exclude_negative_lobes, True, rot_options,
                     ifs_collapse_range=ifs_collapse_range,
                     initial_4dshape=initial_4dshape)


def _pca_grid(cube, angle_list, fwhm, range_pcs, source_xy, cube_ref, mode,
              annulus_width, svd_mode, scaling, mask_center_px, fmerit,
              collapse, verbose, full_output, debug, plot, save_plot,
              start_time, scale_list, weights, exclude_negative_lobes,
              table, rot_options, ifs_collapse_range="all",
              initial_4dshape=None):
    """``pca_grid`` itself; ``table=False`` skips the pandas table (the
    caller discards it), so that ``pca`` imports pandas only for
    ``full_output``."""
    if start_time is None:
        start_time = time_ini(verbose)
    cube = as_tensor(cube)
    n = cube.shape[0]
    if source_xy is not None:
        if fwhm is None:
            raise ValueError("if source_xy is provided, so should fwhm")
        x, y = source_xy
    else:
        x = y = None

    if isinstance(range_pcs, list):
        pclist = range_pcs
        pcmax = max(pclist)
    else:
        if range_pcs is None:
            pcmin, pcmax, step = 1, n - 1, 1
        elif len(range_pcs) == 2:
            pcmin, pcmax = range_pcs
            pcmax = min(pcmax, n)
            step = 1
        elif len(range_pcs) == 3:
            pcmin, pcmax, step = range_pcs
            pcmax = min(pcmax, n)
        else:
            raise TypeError("`range_pcs` must be None or a tuple, "
                            "corresponding to (PC_INI, PC_MAX) or "
                            "(PC_INI, PC_MAX, STEP)")
        pclist = list(range(pcmin, pcmax + 1, step))
    if fmerit not in ["px", "max", "mean"]:
        raise ValueError(f"Invalid value for fmerit: {fmerit}.")

    if mode == "fullfr":
        matrix = prepare_matrix(cube, scaling, mask_center_px, verbose=False)
        ref_lib = matrix if cube_ref is None else prepare_matrix(
            cube_ref, scaling, mask_center_px, verbose=False)
        annind = None
    elif mode == "annular":
        y_cent, x_cent = frame_center(cube[0])
        ann_radius = dist(y_cent, x_cent, y, x)
        inrad = int(ann_radius - annulus_width / 2.0)
        outrad = int(ann_radius + annulus_width / 2.0)
        matrix, annind = prepare_matrix(cube, scaling, None, mode="annular",
                                        inner_radius=inrad,
                                        outer_radius=outrad, verbose=False)
        if cube_ref is not None:
            ref_lib, _ = prepare_matrix(cube_ref, scaling, mask_center_px,
                                        "annular", inner_radius=inrad,
                                        outer_radius=outrad, verbose=False)
        else:
            ref_lib = matrix
    else:
        raise RuntimeError("Wrong mode. Choose either fullfr or annular")

    V = svd_wrapper(ref_lib, _value(svd_mode), pcmax, verbose,
                    to_numpy=False)
    if verbose:
        timing(start_time)

    collapse = _value(collapse)
    imlib = _value(rot_options.get("imlib", "vip-fft"))
    other_rot = {kk: vv for kk, vv in rot_options.items() if kk != "imlib"}
    small = imlib == "vip-fft-small"
    shape = tuple(cube.shape)
    device_ok = (scale_list is None and weights is None
                 and collapse in ("median", "mean", "sum")
                 and imlib in ("vip-fft", "vip-fft-small") and not other_rot
                 and bool(torch.isfinite(cube).all())
                 and (not small or (shape[-1] % 2 == 0
                                    and shape[-2] == shape[-1])))
    if device_ok:
        from ..ops.pipeline import _derotate_frames

        k = len(pclist)
        itemsize = matrix.element_size()
        if small:
            chunk = min(k * n, 4 * _auto_chunk(k * n, shape[-1], itemsize))
        else:
            chunk = _auto_chunk(n, shape[-1], itemsize)
        rot_mode = "fft-small" if small else "fft"

        def derotate(res, angs):
            return _derotate_frames(res, angs, chunk=chunk,
                                    rot_mode=rot_mode)

        def collapse_fn(der):
            return collapse_jax(der, mode=collapse)
    elif scale_list is not None and initial_4dshape is not None:
        from ..preproc.rescaling import _host_vec, _scwave

        z, n_adi, y_in, x_in = initial_4dshape
        idx_ini, idx_fin = (0, z) if ifs_collapse_range == "all" \
            else ifs_collapse_range
        scal = _host_vec(scale_list)[idx_ini:idx_fin]

        def derotate(res, angs):
            res4 = res.reshape(n_adi, z, *res.shape[-2:])[:, idx_ini:idx_fin]
            frames = _scwave(res4.transpose(0, 1), scal, inverse=True,
                             y_in=y_in, x_in=x_in, keep_cube=False)[1]
            return cube_derotate(frames, angs, **rot_options)

        def collapse_fn(der):
            return cube_collapse(der, mode=collapse, w=weights)
    else:
        def derotate(res, angs):
            return cube_derotate(res, angs, **rot_options)

        def collapse_fn(der):
            return cube_collapse(der, mode=collapse, w=weights)
    frlist = _grid_frames(matrix, V, pclist, shape, annind, angle_list,
                          derotate, collapse_fn, stacked=small)
    cubeout = torch.stack(frlist)

    if x is not None and y is not None and fwhm is not None:
        snrlist = []
        fluxlist = []
        for frame in frlist:
            snr_value, flux = _snr_of(frame, y, x, fwhm, fmerit,
                                      exclude_negative_lobes)
            if np.isnan(snr_value):
                snr_value = 0
            snrlist.append(snr_value)
            fluxlist.append(flux)
        argmax = int(np.argmax(snrlist))
        opt_npc = pclist[argmax]
        df = None
        if table or debug:
            from pandas import DataFrame

            df = DataFrame({"PCs": pclist, "S/Ns": snrlist,
                            "fluxes": fluxlist})
        if debug:
            print(df, "\n")
        if verbose:
            print("Number of steps", len(pclist))
            print(f"Optimal number of PCs = {opt_npc}, for "
                  f"S/N={snrlist[argmax]:.3f}")
        if plot:
            _plot_grid(pclist, snrlist, fluxlist, opt_npc, save_plot)
        return cubeout, cubeout[argmax], df, opt_npc

    if verbose:
        print(f"Computed residual frames for PCs interval: {range_pcs}")
        print("Number of steps", len(pclist))
        timing(start_time)
    if full_output:
        return cubeout, pclist
    return cubeout


def _plot_grid(pclist, snrlist, fluxlist, opt_npc, save_plot):
    """S/N and flux against the number of PCs (vip_tpu utils_pca.py:287)."""
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator

    plt.figure(figsize=(8, 6))
    for k, (vec, ylab, col) in enumerate(
            ((snrlist, "S/N", "C0"),
             (fluxlist, "Flux in FWHM ap. [ADUs]", "C1"))):
        ax = plt.subplot(2, 1, k + 1)
        ax.plot(pclist, vec, "-", alpha=0.5, color=col)
        ax.plot(pclist, vec, "o", alpha=0.5, color=col)
        ax.set_xlim(min(pclist), max(pclist))
        ax.set_ylim(min(vec), max(vec) + 1)
        ax.set_ylabel(ylab)
        ax.minorticks_on()
        ax.grid("on", "major", linestyle="solid", alpha=0.4)
        ax.xaxis.set_major_locator(MaxNLocator(integer=True))
        if k == 0:
            ax.set_title(f"Optimal # PCs: {opt_npc}")
        else:
            ax.set_xlabel("Principal components")
    if save_plot is not None:
        plt.savefig(save_plot, dpi=100, bbox_inches="tight")


def pca_annulus(cube, angs, ncomp, annulus_width, r_guess, cube_ref=None,
                svd_mode="lapack", scaling=None, collapse="median",
                weights=None, collapse_ifs="mean", **rot_options):
    """PCA of one annulus (vip_tpu utils_pca.py:323; the NEGFC forward
    model): prepare → SVD → project → derotate → collapse, on the cube's
    device. Returns the collapsed frame, or the derotated (or, without
    ``angs``, raw) residual cube when ``collapse`` is None. A 4-d cube is
    reduced channel by channel (``ncomp`` a scalar or one a channel, a
    3-d ``cube_ref`` shared by all) and the channel frames collapse with
    ``collapse_ifs``; with one int ``ncomp``, no reference, no weights and
    angles, all channels at once (:func:`_pca_annulus_channels`)."""
    cube = as_tensor(cube)
    if cube.ndim == 3:
        return _pca_annulus_3d(cube, angs, ncomp, annulus_width, r_guess,
                               cube_ref, svd_mode, scaling, collapse, weights,
                               **rot_options)
    if cube.ndim != 4:
        raise TypeError("Input cube must be 3d or 4d")
    nch = cube.shape[0]
    if cube_ref is not None and cube_ref.ndim == 3:
        cube_ref = [cube_ref] * nch
    if np.isscalar(ncomp):
        ncomp = [ncomp] * nch
    elif isinstance(ncomp, list) and len(ncomp) != nch:
        raise TypeError("If ncomp is a list, in the case of a 4d input cube "
                        "without input scale_list, it should have the same "
                        "length as the first dimension of the cube.")
    if collapse is None:
        raise ValueError("mode not supported. Provide value for collapse")
    from .svd import MODE_TO_METHOD

    method = MODE_TO_METHOD.get(_value(svd_mode))
    if (cube_ref is None and weights is None and angs is not None
            and len(set(ncomp)) == 1
            and isinstance(ncomp[0], (int, np.integer))
            and method in ("lapack", "eigen")):
        ifs_res = _pca_annulus_channels(cube, angs, int(ncomp[0]),
                                        annulus_width, r_guess, method,
                                        scaling, _value(collapse),
                                        **rot_options)
        return cube_collapse(ifs_res, mode=_value(collapse_ifs))
    ifs_res = torch.stack([_pca_annulus_3d(
        cube[ch], angs, ncomp[ch], annulus_width, r_guess,
        cube_ref[ch] if cube_ref is not None else None, svd_mode, scaling,
        collapse, weights, **rot_options) for ch in range(nch)])
    return cube_collapse(ifs_res, mode=_value(collapse_ifs))


def _pca_annulus_channels(cube, angs, ncomp, annulus_width, r_guess,
                          method, scaling, collapse, **rot_options):
    """``_pca_annulus_3d`` of every channel of a (z, n, y, x) cube at
    once: the z annulus matrices in one batched ``svd_top``, the z·n
    residual frames in one ``cube_derotate`` (the angles tiled), and each
    channel's frames collapsed together (the median in one call over (n,
    z·y, x)). Returns the (z, y, x) channel frames."""
    from ..ops.linalg import matrix_scaling_jax, svd_top

    z, n, y, x = cube.shape
    inrad = int(r_guess - annulus_width / 2.0)
    outrad = int(r_guess + annulus_width / 2.0)
    flat, ind = prepare_matrix(cube.reshape(z * n, y, x), None,
                               mode="annular", verbose=False,
                               inner_radius=inrad, outer_radius=outrad)
    data = matrix_scaling_jax(flat.reshape(z, n, -1), scaling)
    if ncomp > min(n, data.shape[-1]):
        raise RuntimeError(
            f"{ncomp} PCs cannot be obtained from a matrix with size "
            f"[{n},{data.shape[-1]}]. Increase the size of the patches or "
            "request less PCs")
    V = svd_top(data, ncomp, method=method)
    residuals = data - (data @ V.mT) @ V
    cube_zeros = cube.new_zeros((z * n, y, x))
    cube_zeros[:, torch.as_tensor(ind[0], device=cube.device),
               torch.as_tensor(ind[1], device=cube.device)] = \
        residuals.reshape(z * n, -1)
    angs = np.asarray(angs.cpu() if isinstance(angs, torch.Tensor) else angs,
                      dtype=float)
    der = cube_derotate(cube_zeros, np.tile(angs, z), **rot_options)
    der = der.reshape(z, n, y, x)
    if collapse == "median":
        frames = der.transpose(0, 1).reshape(n, z * y, x)
        return collapse_jax(frames.contiguous(), mode="median").reshape(
            z, y, x)
    return collapse_jax(der, mode=collapse, ax=1)


def _pca_annulus_3d(cube, angs, ncomp, annulus_width, r_guess, cube_ref,
                    svd_mode, scaling, collapse, weights, **rot_options):
    inrad = int(r_guess - annulus_width / 2.0)
    outrad = int(r_guess + annulus_width / 2.0)
    data, ind = prepare_matrix(cube, scaling, mode="annular", verbose=False,
                               inner_radius=inrad, outer_radius=outrad)
    if cube_ref is not None:
        data_svd, _ = prepare_matrix(cube_ref, scaling, mode="annular",
                                     verbose=False, inner_radius=inrad,
                                     outer_radius=outrad)
    else:
        data_svd = data
    V = svd_wrapper(data_svd, _value(svd_mode), ncomp, verbose=False,
                    to_numpy=False)
    residuals = data - (data @ V.T) @ V
    cube_zeros = torch.zeros_like(cube)
    cube_zeros[:, torch.as_tensor(ind[0], device=cube.device),
               torch.as_tensor(ind[1], device=cube.device)] = residuals
    if angs is not None:
        cube_res_der = cube_derotate(cube_zeros, angs, **rot_options)
        if collapse is not None:
            return cube_collapse(cube_res_der, mode=collapse, w=weights)
        return cube_res_der
    if collapse is not None:
        return cube_collapse(cube_zeros, mode=collapse, w=weights)
    return cube_zeros


def _incremental_merge_svd(basis, blk, mean, count, keep):
    """One merge-and-truncate step of the streamed SVD (vip_tpu
    utils_pca.py:391): the eigh of the small Gram matrix of ``stack =
    [basis; centred block; mean correction]`` gives the new S-scaled basis
    as ``Uᵀ @ stack``, truncated to ``keep`` rows as sklearn's
    IncrementalPCA truncates. ``count`` is a Python number."""
    m = blk.shape[0]
    new_count = count + m
    blk_mean = blk.mean(dim=0)
    mean_corr = math.sqrt(count * m / new_count) * (blk_mean - mean)
    stack = torch.cat([basis, blk - blk_mean, mean_corr[None]])
    _, U = torch.linalg.eigh(stack @ stack.T)     # ascending eigenvalues
    top = U[:, -keep:].flip(1)                    # top-keep, descending
    new_mean = (count * mean + m * blk_mean) / new_count
    return top.T @ stack, new_mean, new_count


def _project_subtract_blk(blk, mean, V):
    """Pass-2 residuals of one block (vip_tpu utils_pca.py:421)."""
    M = blk - mean
    return M - (M @ V.T) @ V


def _wire_dtype(wire_dtype, work):
    """The torch dtype blocks travel in from the host."""
    if wire_dtype is None:
        return work
    if str(wire_dtype) in ("bfloat16", "bf16"):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(wire_dtype))).dtype


def pca_incremental(cube, angle_list, batch=0.25, ncomp=1, collapse="median",
                    verbose=True, full_output=False, start_time=None,
                    weights=None, nproc=1, imlib="vip-fft",
                    interpolation="lanczos4", return_residuals=False,
                    wire_dtype=None, pixel_mesh=None, **rot_options):
    """Incremental (out-of-core) full-frame PCA (vip_tpu utils_pca.py:430;
    same parameters and returns).

    ``cube`` is a FITS path (read lazily: only ``batch`` frames are
    decoded at a time), a lazy HDU, an array or a tensor. The work runs
    on the default device (:func:`vip_tpu_torch.set_device`), or on the
    tensor's own, in float32 on a card (float64 for a float64 tensor) and
    float64 on the CPU (the parity mode). ``batch``: an int is frames a batch, a float in (0, 1) the
    fraction of the available host memory a batch may take.

    Pass 1 merges each batch into the truncated SVD (exactly ``ncomp``
    rows). A host thread reads the next batch ahead; blocks cross to the
    card from pinned memory, and stay there for pass 2 when the whole
    cube takes at most a quarter of the card's free memory. Pass 2
    projects each batch and, for ``imlib='vip-fft'`` with no weights or
    rotation options and collapse 'median', 'mean' or 'sum', derotates and
    collapses it on the device in chunks of 50 frames (CUDA kernels H2
    and H1 on the card); otherwise through ``cube_derotate`` and
    ``cube_collapse``. The final frame is the host ``np.median`` of the
    per-batch frames, a numpy array, as are ``full_output``'s (frame,
    None, pcs, medians) and ``return_residuals``' cube.

    ``wire_dtype="bfloat16"`` casts each block on the host with
    ``torch.bfloat16`` and upcasts it on the device: half the bytes over
    the link, at ~4e-3 of the cube's dynamic range (see vip_tpu).

    ``pixel_mesh``: a 1-D mesh (``config.frame_mesh``) over which every
    block's PIXEL axis is split (vip_tpu's multi-device streamed PCA):
    each rank holds 1/n_dev of every block, of the basis and of the mean,
    the merge all_reduces one small Gram a block, and pass 2 reshards
    pixels → frames for the local derotation
    (``psfsub.sharded.make_sharded_incremental_merge``). It needs the
    device tail (``imlib='vip-fft'``, no weights or rotation options,
    collapse 'median', 'mean' or 'sum', ``return_residuals=False``), as
    vip_tpu's; the block cache is scaled by the mesh.
    """
    from ..config.mem import get_available_hbm, get_available_memory
    from ..preproc.derotation import cube_derotate

    if pixel_mesh is not None and (
            return_residuals or _value(imlib) != "vip-fft"
            or weights is not None or rot_options
            or str(_value(collapse)) not in ("median", "mean", "sum")):
        raise ValueError(
            "pixel_mesh requires the device-resident tail: imlib='vip-fft',"
            " no weights/rot_options, collapse in ('median','mean','sum')"
            " and return_residuals=False — drop pixel_mesh to use the"
            " host-fallback path")
    from ..fits import open_fits
    from ..fits.fits import _LazyHDU

    if isinstance(cube, str):
        cube = open_fits(cube, n=0, return_memmap=True, verbose=False)
    if isinstance(angle_list, str):
        angle_list = open_fits(angle_list, verbose=False)
    angle_list = np.asarray(angle_list.detach().cpu() if isinstance(
        angle_list, torch.Tensor) else angle_list, dtype=np.float64)
    n = cube.shape[0]
    y, x = cube.shape[1:]
    npx = y * x
    collapse, imlib = _value(collapse), _value(imlib)
    interpolation = _value(interpolation)

    if start_time is None:
        start_time = time_ini(verbose)

    if isinstance(batch, float):
        if not 0 < batch < 1:
            raise ValueError("float `batch` must lie in (0, 1)")
        budget = batch * get_available_memory(False)
        batch_size = int(min(n, max(1, budget // (npx * 8))))
    else:
        batch_size = min(n, int(batch))
    n_batches = int(np.ceil(n / batch_size))
    if verbose:
        print(f"Cube: {n} frames; batch size = {batch_size} frames "
              f"({n_batches} batches)")

    dev = cube.device if isinstance(cube, torch.Tensor) else get_device()
    work = torch.float32 if dev.type == "cuda" else torch.float64
    if isinstance(cube, torch.Tensor) and cube.dtype == torch.float64:
        work = torch.float64        # a float64 tensor keeps its precision
    wire = _wire_dtype(wire_dtype, work)
    work_np = np.float32 if work == torch.float32 else np.float64

    # a float32 lazy HDU bound for a card with a float32 wire decodes each
    # block straight into pinned memory (the same decode, so the same bits)
    decode_pinned = (isinstance(cube, _LazyHDU) and dev.type == "cuda"
                     and wire == torch.float32
                     and np.dtype(cube._precision) == np.float32)

    def read_batch(b):
        """Host (or the tensor's) block ``b`` in the wire dtype, pinned
        when it will cross to a card."""
        lo, hi = b * batch_size, min(n, (b + 1) * batch_size)
        if decode_pinned:
            blk = torch.empty((hi - lo, npx), dtype=torch.float32,
                              pin_memory=True)
            cube._read_frames(lo, hi, out=blk)
            return blk
        blk = cube[lo:hi]
        if isinstance(blk, torch.Tensor):
            return blk.reshape(blk.shape[0], npx).to(wire)
        blk = torch.from_numpy(np.ascontiguousarray(
            np.asarray(blk, dtype=work_np).reshape(-1, npx))).to(wire)
        return blk.pin_memory() if dev.type == "cuda" else blk

    def to_device(blk):
        blk = blk.to(dev, non_blocking=True)
        return blk if blk.dtype == work else blk.to(work)

    def prefetched_blocks():
        """(index, block) while one host thread reads the next block."""
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(read_batch, 0)
            for b in range(n_batches):
                blk = nxt.result()
                if b + 1 < n_batches:
                    nxt = pool.submit(read_batch, b + 1)
                yield b, blk

    if pixel_mesh is not None:
        return _run_incremental_sharded(
            pixel_mesh, prefetched_blocks, angle_list, y, x, npx,
            batch_size, n_batches, int(ncomp), dev, work, collapse,
            verbose, start_time, full_output)

    # pass 1: streaming mean and merge-and-truncate SVD of the centred data
    k = int(ncomp)
    mean = torch.zeros(npx, dtype=work, device=dev)
    count = 0
    basis = torch.zeros((k, npx), dtype=work, device=dev)
    budget = _CACHE_FRACTION * get_available_hbm(dev)
    cache_on_device = n * npx * torch.finfo(work).bits // 8 <= budget
    dev_blocks = []
    for b, blk in prefetched_blocks():
        blk_d = to_device(blk)
        if cache_on_device:
            dev_blocks.append(blk_d)
        basis, mean, count = _incremental_merge_svd(basis, blk_d, mean,
                                                    count, k)
        if verbose:
            print(f"Batch {b + 1}/{n_batches} processed")
    norms = torch.linalg.norm(basis, dim=1, keepdim=True)
    V = basis / torch.where(norms == 0, 1.0, norms)

    def pass2_blocks():
        if cache_on_device:
            yield from enumerate(dev_blocks)
        else:
            for b, blk in prefetched_blocks():
                yield b, to_device(blk)

    device_tail = (imlib == "vip-fft" and weights is None and not rot_options
                   and str(collapse) in ("median", "mean", "sum"))
    if return_residuals:
        residuals_all = np.empty((n, y, x))
    medians = []
    for b, blk in pass2_blocks():
        lo = b * batch_size
        m_b = blk.shape[0]
        resid = _project_subtract_blk(blk, mean, V).reshape(-1, y, x)
        angs = angle_list[lo:lo + m_b]
        if return_residuals:
            residuals_all[lo:lo + m_b] = resid.cpu().numpy()
        elif device_tail:
            from ..ops.pipeline import derotate_collapse

            medians.append(derotate_collapse(
                resid, as_tensor(angs, dev, work), collapse=collapse,
                chunk=50))
        else:
            der = cube_derotate(resid, angs, nproc=nproc, imlib=imlib,
                                interpolation=interpolation, **rot_options)
            medians.append(cube_collapse(der, mode=collapse, w=weights))
    if return_residuals:
        return residuals_all
    medians = np.array([m_.cpu().numpy() for m_ in medians])
    frame = np.median(medians, axis=0)
    if verbose:
        timing(start_time)
    if full_output:
        return frame, None, V.reshape(-1, y, x).cpu().numpy(), medians
    return frame


def _run_incremental_sharded(mesh, blocks, angle_list, y, x, npx, batch_size,
                             n_batches, k, dev, work, collapse, verbose,
                             start_time, full_output):
    """``pca_incremental(pixel_mesh=...)``: the pixel-sharded merge and
    the resharded pass 2 (vip_tpu utils_pca.py:663). ``blocks`` is the
    prefetching generator of host blocks; it runs again for pass 2 when
    the blocks are not cached on the device. Every block is zero-padded
    to one (m_pad, npx_pad) shape that divides over the mesh (exact: the
    pad rows are masked and the pad pixels add nothing), and each rank
    moves only its pixel columns to its device."""
    from ..config.mem import get_available_hbm
    from ..config.parallel import all_gather, from_local
    from .sharded import (make_sharded_incremental_merge,
                          make_sharded_incremental_normalize,
                          make_sharded_incremental_pass2)

    W, r = mesh.size(), mesh.get_local_rank()
    npx_pad = -(-npx // W) * W
    m_pad = -(-batch_size // W) * W
    pl = npx_pad // W
    lo_px, hi_px = r * pl, min((r + 1) * pl, npx)

    def put_block(blk):
        """This rank's pixel columns of a block, zero-padded to (m_pad,
        pl), in the work dtype on the device, as a pixel-sharded
        DTensor; and the block's number of frames."""
        m_b = blk.shape[0]
        loc = blk.new_zeros((m_pad, pl))
        if hi_px > lo_px:
            loc[:m_b, :hi_px - lo_px] = blk.reshape(m_b, npx)[:, lo_px:hi_px]
        return from_local(loc.to(dev, non_blocking=True).to(work), mesh,
                          1), m_b

    basis = from_local(torch.zeros((k, pl), dtype=work, device=dev), mesh, 1)
    mean = from_local(torch.zeros(pl, dtype=work, device=dev), mesh, 0)
    count = 0.0
    # the card's block cache of the single-device path, scaled by the
    # mesh: each rank holds 1/n_dev of every cached block
    budget = _CACHE_FRACTION * get_available_hbm(dev) * W
    cache_on_device = (n_batches * m_pad * npx_pad
                       * torch.finfo(work).bits // 8) <= budget
    cache = []

    merge = make_sharded_incremental_merge(mesh, k, m_pad)
    for b, blk in blocks():
        blk_d, m_b = put_block(blk)
        if cache_on_device:
            cache.append((blk_d, m_b))
        basis, mean, count = merge(basis, blk_d, mean, count, m_b)
        if verbose:
            print(f"Batch {b + 1}/{n_batches} processed")
    V = make_sharded_incremental_normalize(mesh)(basis)
    pass2 = make_sharded_incremental_pass2(mesh, (y, x), npx,
                                           collapse=str(collapse))

    def pass2_blocks():
        if cache_on_device:
            yield from enumerate(cache)
        else:
            for b, blk in blocks():
                yield b, put_block(blk)

    medians = []
    for b, (blk_d, m_b) in pass2_blocks():
        lo = b * batch_size
        ang = np.zeros(m_pad, np.float64)
        ang[:m_b] = angle_list[lo:lo + m_b]
        medians.append(pass2(blk_d, mean, V, ang, m_b).cpu().numpy())
    medians = np.array(medians)
    frame = np.median(medians, axis=0)
    if verbose:
        timing(start_time)
    if full_output:
        V_all = all_gather(V.to_local().T.contiguous(), mesh).T
        return (frame, None, V_all[:, :npx].reshape(-1, y, x).cpu().numpy(),
                medians)
    return frame

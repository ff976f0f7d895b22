"""End-to-end device pipelines (port of ``vip_tpu.ops.pipeline``).

The main path, full-frame PCA-ADI: scale the frame matrix → top-k PCs →
project and subtract → derotate every residual frame with VIP's exact
4x-padded three-shear FFT rotation (CUDA kernel H2) → per-pixel temporal
median (CUDA kernel H1). PyTorch runs eagerly on the tensors' device, so
where vip_tpu compiled one XLA program, these are plain functions.
"""

import torch

from ..config.device import as_tensor
from ..preproc.derotation import _rotate_chunks
from ..preproc.subsampling import collapse_jax
from .fft import rotate_fft_fast_batch
from .linalg import matrix_scaling_jax, svd_top
from .median import nanmedian_axis0, nanmedian_plain, nanmedian_supported

__all__ = ["pca_adi_pipeline", "derotate_collapse", "median_adi_pipeline"]


def _derotate_frames(cube, angles, chunk=None, rot_mode="fft",
                     interpolation="bicubic"):
    """Derotate (rotate by -angles) a (n, y, x) tensor in chunks of
    ``chunk`` frames. rot_mode='fft' is VIP's exact flux-preserving
    rotation (``ops.shear.rotate_exact``); 'fft-small' the packed
    three-shear rotation on a 1.25x canvas restricted to the inscribed
    circle (pixels outside it come back 0)."""
    angles = as_tensor(angles, cube.device, cube.dtype)
    if rot_mode == "interp":
        raise NotImplementedError(
            "rot_mode='interp' waits for the port of ops/interp_rotation.py "
            "(ROADMAP Queue 1, slice 8)")
    if rot_mode == "fft":
        return _rotate_chunks(cube, -angles, chunk)
    if rot_mode != "fft-small":
        raise ValueError(f"rot_mode {rot_mode!r} not recognized")

    # the shear intermediates of circle-masked content reach at most
    # 1.082 R for |angle| <= 45 deg, so a 1.25x canvas is wrap-free
    n, sz = cube.shape[0], cube.shape[-1]
    pad_to = -(-int(sz * 1.25) // 2) * 2  # even ceil
    m0 = (pad_to - sz) // 2
    m1 = pad_to - sz - m0
    qq = torch.arange(sz, device=cube.device) - sz / 2
    fov = (qq[:, None] ** 2 + qq[None, :] ** 2) < (sz / 2) ** 2

    def _rot_small(frames, angs):
        frames = torch.where(fov, frames, 0.0)
        padded = torch.nn.functional.pad(frames, (m0, m1, m0, m1))
        # prune the two x-shears to the content/crop row slab (+1 for the
        # quadrant-rot90 shift) — exactness-preserving
        out = rotate_fft_fast_batch(padded, angs,
                                    support_rows=(m0, min(pad_to - m0,
                                                          sz + 1)))
        return out[:, m0:m0 + sz, m0:m0 + sz]

    if chunk is None or chunk >= n:
        return _rot_small(cube, -angles)
    out = torch.empty_like(cube)
    for s in range(0, n, chunk):
        out[s:s + chunk] = _rot_small(cube[s:s + chunk],
                                      -angles[s:s + chunk])
    return out


def pca_adi_pipeline(cube, angles, ncomp=10, method="eigen",
                     collapse="median", scaling=None, chunk=None,
                     rot_mode="fft", interpolation="bicubic"):
    """Full-frame PCA-ADI reduction (vip_tpu pipeline.py:175).

    cube: (n, y, x); angles: (n,) derotation angles [deg]. Returns the
    collapsed residual frame (y, x) on the cube's device.
    """
    cube = as_tensor(cube)
    n, y, x = cube.shape
    M = matrix_scaling_jax(cube.reshape(n, -1), scaling)
    V = svd_top(M, ncomp, method=method)
    # residuals live in the scaled space, like VIP's _project_subtract
    resid = (M - (M @ V.T) @ V).reshape(n, y, x)
    der = _derotate_frames(resid, angles, chunk=chunk, rot_mode=rot_mode,
                           interpolation=interpolation)
    return collapse_jax(der, mode=collapse)


def derotate_collapse(cube, angles, collapse="median", chunk=None,
                      rot_mode="fft", interpolation="bicubic"):
    """Derotate + collapse only (the tail of every ADI algorithm)."""
    cube = as_tensor(cube)
    der = _derotate_frames(cube, angles, chunk=chunk, rot_mode=rot_mode,
                           interpolation=interpolation)
    return collapse_jax(der, mode=collapse)


def median_adi_pipeline(cube, angles, collapse="median", chunk=None):
    """Full-frame median-ADI: subtract the per-pixel median (any NaN
    propagates, as ``numpy.median``), derotate, collapse."""
    cube = as_tensor(cube)
    if nanmedian_supported(cube, 0):
        model = nanmedian_axis0(cube.contiguous(), propagate=True)
    else:
        model = nanmedian_plain(cube, 0, propagate=True)
    return derotate_collapse(cube - model, angles, collapse=collapse,
                             chunk=chunk)

"""Several devices: the S/N map with the radius rows of the polar engine
on the ranks of a mesh, and the contrast curve's injection patterns laid
over the ranks (port of ``vip_tpu.metrics.sharded``).

The polar engine (``ops.apertures.polar_snr_rows``) computes each radius
row on its own, so each rank takes a band of rows of the replicated frame,
one all_gather assembles the (n_r, n_theta) grid, and every rank maps it
back to the frame. The patterns need no collective until their frames are
gathered: each rank reduces its share with ``ops.pipeline.
pca_adi_pipeline`` (CUDA kernels H2 and H1 on a card).
"""

import numpy as np
import torch

from ..config.device import as_tensor, get_device
from ..config.parallel import all_gather, frame_mesh, replicated

__all__ = ["make_sharded_snrmap", "sharded_snrmap",
           "sharded_pattern_frames"]


def make_sharded_snrmap(mesh, shape, fwhm, n_theta=0,
                        exclude_negative_lobes=False, axis="px"):
    """The sharded S/N-map step for frames of ``shape`` (vip_tpu
    sharded.py:27): ``step(frame)`` → the S/N map in the frame's dtype,
    the frame replicated (every rank passes it whole) and the map
    replicated. The radius rows
    are padded to a multiple of the mesh with copies of the last one,
    dropped after the gather."""
    from ..ops.apertures import polar_snr_rows, polar_snr_to_cart

    ny, nx = shape
    cy = ny / 2 if ny % 2 == 0 else (ny - 1) / 2
    cx = nx / 2 if nx % 2 == 0 else (nx - 1) / 2
    r_ap = fwhm / 2.0
    n_r = int(min(cy, cx, ny - cy, nx - cx)) - int(np.ceil(r_ap)) - 1
    if n_theta == 0:
        n_theta = 4 * max(ny, nx)
    band = -(-n_r // mesh.size())   # radius rows a rank
    radii_pad = np.pad(np.arange(1, n_r + 1, dtype=float),
                       (0, band * mesh.size() - n_r), mode="edge")

    def step(frame):
        frame = replicated(frame)
        lo = mesh.get_local_rank() * band
        radii = torch.as_tensor(radii_pad[lo:lo + band], dtype=frame.dtype,
                                device=frame.device)
        rows = polar_snr_rows(frame, radii, fwhm, n_theta,
                              exclude_negative_lobes)
        snr_p = all_gather(rows, mesh)[:n_r]
        return polar_snr_to_cart(snr_p, (ny, nx), fwhm, n_theta)

    return step


def sharded_snrmap(frame, fwhm, mesh=None, **kwargs):
    """The sharded polar S/N engine of a float32 frame, as a host map
    (vip_tpu sharded.py:60)."""
    if mesh is None:
        mesh = frame_mesh(axis_name="px")
    if isinstance(frame, torch.Tensor):
        frame = frame.detach()
    fn = make_sharded_snrmap(mesh, tuple(frame.shape), float(fwhm), **kwargs)
    return fn(as_tensor(frame, dtype=torch.float32)).cpu().numpy()


def sharded_pattern_frames(cubes_fc, angles, mesh=None, ncomp=5,
                           method="eigen", collapse="median",
                           rot_mode="fft", chunk=None):
    """The contrast curve's injected cubes (one per radial pattern and
    branch) laid over the mesh (vip_tpu sharded.py:71): each rank reduces
    its share with ``pca_adi_pipeline``, the frames are gathered, and
    every rank returns all of them as a host (n_patterns, y, x) array.
    The patterns are padded to a multiple of the mesh with copies of the
    last cube, dropped after the gather. Numpy cubes go to the port's
    device under its dtype policy, a tensor stays on its own."""
    from ..ops.pipeline import pca_adi_pipeline

    if mesh is None:
        mesh = frame_mesh(axis_name="patterns")
    W, r = mesh.size(), mesh.get_local_rank()
    n_pat = len(cubes_fc)
    per = -(-n_pat // W)
    mine = [min(i, n_pat - 1) for i in range(r * per, (r + 1) * per)]
    frames = []
    for i in mine:
        cube = as_tensor(cubes_fc[i])
        if cube.device.type != get_device().type:
            cube = cube.to(get_device())
        angs = as_tensor(np.asarray(angles.detach().cpu() if isinstance(
            angles, torch.Tensor) else angles, float), cube.device,
            cube.dtype)
        frames.append(pca_adi_pipeline(cube, angs, ncomp=ncomp,
                                       method=method, collapse=collapse,
                                       chunk=chunk, rot_mode=rot_mode))
    return all_gather(torch.stack(frames), mesh)[:n_pat].cpu().numpy()

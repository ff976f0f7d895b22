"""Several devices: PCA-ADI, median-ADI, annular PCA, the single-pass
ADI+mSDI PCA and the streamed PCA with one axis of the data laid over the
ranks of a mesh (port of ``vip_tpu.psfsub.sharded``).

vip_tpu runs each step as one ``shard_map`` program over a device mesh.
Here every rank of a ``torch.distributed`` mesh (``config.frame_mesh``)
runs the same step on its slab, and the stages talk through
``config.parallel``'s collectives:

  Gram matrix   C = M Mᵀ       — all_gather(M) + local matmul
  eigh(C)                      — replicated: every rank factors C itself
  PCs           V = EVᵀ M      — local matmul on the gathered M
  projection    M - (M Vᵀ) V   — local, on the gathered M
  derotation                   — local: ``ops.shear.rotate_exact`` (CUDA
                                 kernel H2 on a card's float32 frames)
  collapse                     — all_reduce (mean) or an all_to_all
                                 reshard and a local median (CUDA kernel
                                 H1 on a card's float32 frames)

Each ``make_sharded_*`` returns the step, a plain function. It takes the
global arrays of vip_tpu's jitted step: a ``DTensor`` (``shard_cube``)
gives its local slab, any other array or tensor is cut to this rank's
slab (numpy on the host, before it moves). Its result is replicated:
every rank returns the same tensor. The ``sharded_*`` wrappers return
host numpy, as vip_tpu's. vip_tpu's divisibility rules and messages stay.
"""

import math

import numpy as np
import torch

from ..config.parallel import (all_gather, all_reduce, all_to_all,
                               frame_mesh, from_local, local_slab, replicated,
                               shard_cube)
from ..ops.median import nanmedian_axis0, nanmedian_plain, nanmedian_supported
from ..preproc.derotation import _auto_chunk, _rotate_chunks

__all__ = ["sharded_pca_adi", "make_sharded_pca_adi",
           "make_sharded_median_adi", "make_sharded_pca_annular",
           "sharded_pca_annular", "make_sharded_pca_sdi_single",
           "sharded_pca_sdi_single", "make_sharded_incremental_merge",
           "make_sharded_incremental_normalize",
           "make_sharded_incremental_pass2"]


def _host(t):
    return t.detach().cpu().numpy()


def _float(cube):
    """A numpy cube as float64 (vip_tpu's ``np.asarray(cube, float)``; the
    port's dtype policy then takes it to float32 on a card); a tensor as
    it is."""
    return cube if isinstance(cube, torch.Tensor) \
        else np.asarray(cube, dtype=float)


def _derotate(frames, angles):
    """Rotate (n, y, x) frames by -angles with VIP's exact FFT rotation, in
    ``cube_derotate``'s chunks (H2 on a card's float32 frames)."""
    n, y = frames.shape[:2]
    return _rotate_chunks(frames, -angles,
                          _auto_chunk(n, y, frames.element_size()))


def _median0(x, propagate):
    """Median along axis 0 of a 3-d tensor: ``ops.median.nanmedian_axis0``
    (H1) on the CPU's plain version or a card's float32 frames; the plain
    version for other card dtypes."""
    if x.device.type == "cpu" or nanmedian_supported(x, 0):
        return nanmedian_axis0(x.contiguous(), propagate)
    return nanmedian_plain(x, 0, propagate)


def _collapse(der_loc, mesh, collapse, n_total):
    """The replicated frame of the (sharded) frame axis: the median
    reshard, or the mean."""
    if collapse == "median":
        return _sharded_median(der_loc, mesh)
    return all_reduce(der_loc.sum(dim=0), mesh) / n_total


def _sharded_median(der_loc, mesh):
    """Median over the (sharded) frame axis (vip_tpu sharded.py:239): an
    all_to_all reshards frame-sharded (n_loc, y, x) to row-sharded (n,
    y_loc, x), every rank takes the median of its row slab, and an
    all_gather returns the full frame. ``numpy.median``'s NaN rule."""
    y, W = der_loc.shape[1], mesh.size()
    if y % W:
        raise ValueError(f"y ({y}) must divide evenly over {W} devices for "
                         "the median reshard")
    full = all_to_all(der_loc, mesh, 1, 0)
    return all_gather(_median0(full, True), mesh)


def _frames_and_angles(cube, angles, mesh):
    cube_loc = local_slab(cube, mesh)
    ang_loc = local_slab(angles, mesh, device=cube_loc.device,
                         dtype=cube_loc.dtype)
    return cube_loc, ang_loc


def _pca_residual(M_loc, ncomp, mesh):
    """This rank's rows of M - (M Vᵀ) V for the frame-sharded matrix M
    (rows on the ranks) and its top-``ncomp`` PCs V: the Gram of the
    all_gathered rows, its eigh, V = EVᵀ M and the projection, each on
    the whole gathered M on every rank.

    A departure from vip_tpu, which forms its rows of C and gathers them
    and reduces the ranks' partial products of all n rows of V: here
    every product has the shape it has on one device, so C, V and the
    residual carry the same bits on every mesh and on one device. A PCA
    of near-degenerate noise would otherwise turn its last PCs with the
    float32 rounding of the row blocks, and a PCA whose residual is a
    small part of M (an IFS halo) would carry that rounding into the
    residual. The cost is W times vip_tpu's Gram arithmetic on a mesh of
    W ranks (n²·p operations a rank), next to the gather of M itself."""
    m_loc = M_loc.shape[0]
    M_full = all_gather(M_loc, mesh)
    e, EV = torch.linalg.eigh(M_full @ M_full.T)
    top = EV[:, -ncomp:].flip(1)                   # descending eigenvalues
    S = torch.sqrt(torch.abs(e)).flip(0)[:ncomp]
    V = (top.T @ M_full) / S[:, None]
    lo = mesh.get_local_rank() * m_loc
    return (M_full - (M_full @ V.T) @ V)[lo:lo + m_loc]


def make_sharded_pca_adi(mesh, ncomp, axis="frames", collapse="mean"):
    """The sharded PCA-ADI step for ``mesh`` (vip_tpu sharded.py:38):
    ``step(cube, angles)`` → the collapsed frame, with ``cube`` and
    ``angles`` sharded along frames."""
    if collapse not in ("mean", "median"):
        raise ValueError("sharded collapse supports 'mean' and 'median'")

    def step(cube, angles):
        cube_loc, ang_loc = _frames_and_angles(cube, angles, mesh)
        n_loc, y, x = cube_loc.shape
        resid = _pca_residual(cube_loc.reshape(n_loc, -1), ncomp,
                              mesh).reshape(n_loc, y, x)
        return _collapse(_derotate(resid, ang_loc), mesh, collapse,
                         n_loc * mesh.size())

    return step


def _check_frames(n, mesh):
    n_dev = mesh.size()
    if n % n_dev:
        raise ValueError(f"n_frames ({n}) must divide evenly over "
                         f"{n_dev} devices")


def sharded_pca_adi(cube, angles, ncomp=5, mesh=None):
    """Shard, run :func:`make_sharded_pca_adi`'s step (collapse 'mean'),
    return the host frame (vip_tpu sharded.py:88)."""
    if mesh is None:
        mesh = frame_mesh()
    _check_frames(cube.shape[0], mesh)
    fn = make_sharded_pca_adi(mesh, ncomp)
    return _host(fn(shard_cube(cube, mesh), shard_cube(angles, mesh)))


def make_sharded_pca_annular(mesh, segments, ncomp, axis="frames",
                             collapse="median", method="eigen",
                             scaling=None, frame_shape=None, *,
                             mask_zeros=True):
    """Sharded annular PCA (vip_tpu sharded.py:105): per (annulus,
    segment), every rank all_gathers the segment matrix and runs the
    masked per-frame PCA of ``ops.annular`` for its own frames; the
    derotation stays frame-local, the collapse reshards.

    ``segments``: (yy, xx) pixel index arrays, one per (annulus,
    segment). The step is ``step(cube, angles, masks, keffs)`` with the
    library masks (S, n, n) and effective ranks (S, n) sharded along
    their frame axis (dim 1). ``mask_zeros``: pixels that are zero
    before the derotation stay zero after it (``pca_annular``'s
    ``mask_val=0`` rotation option, which it takes with a nonzero
    ``radius_int``)."""
    from ..ops.annular import _masked_top_v

    if collapse not in ("mean", "median"):
        raise ValueError("sharded collapse supports 'mean' and 'median'")
    if scaling not in (None, "temp-mean", "temp-standard"):
        raise ValueError("sharded annular PCA supports scaling in "
                         "(None, 'temp-mean', 'temp-standard')")
    if frame_shape is None:
        fx = int(max(int(np.max(xx)) for _yy, xx in segments)) + 1
    else:
        fx = int(frame_shape[1])
    seg_idx = [np.asarray(yy, np.int64) * fx + np.asarray(xx, np.int64)
               for yy, xx in segments]

    def step(cube, angles, masks, keffs):
        cube_loc, ang_loc = _frames_and_angles(cube, angles, mesh)
        dev, dt = cube_loc.device, cube_loc.dtype
        masks_loc = local_slab(masks, mesh, dim=1, device=dev,
                               dtype=torch.bool)
        keff_loc = local_slab(keffs, mesh, dim=1, device=dev,
                              dtype=torch.int64)
        n_loc, ny, nx = cube_loc.shape
        n_tot = n_loc * mesh.size()
        flat = cube_loc.reshape(n_loc, ny * nx)
        resid = torch.zeros_like(flat)
        keep = torch.arange(ncomp, device=dev)
        for s, idx in enumerate(seg_idx):
            idx = torch.as_tensor(idx, device=dev)
            seg = flat[:, idx]
            if scaling is not None:
                # temporal moments over the sharded frame axis
                mu = all_reduce(seg.sum(dim=0), mesh) / n_tot
                seg = seg - mu[None]
                if scaling == "temp-standard":
                    std = torch.sqrt(all_reduce((seg ** 2).sum(dim=0),
                                                mesh) / n_tot)
                    seg = seg / torch.where(std == 0, 1.0, std)[None]
            lib = all_gather(seg, mesh)[None] * masks_loc[s][:, :, None].to(dt)
            V = _masked_top_v(lib, ncomp, method)     # (n_loc, ncomp, p)
            V = torch.where((keep[None] < keff_loc[s][:, None])[..., None],
                            V, 0.0)
            coef = torch.einsum("fp,fkp->fk", seg, V)
            resid[:, idx] = seg - torch.einsum("fk,fkp->fp", coef, V)
        resid = resid.reshape(n_loc, ny, nx)
        der = _derotate(resid, ang_loc)
        if mask_zeros:
            der = torch.where(resid == 0, 0.0, der)
        return _collapse(der, mesh, collapse, n_tot)

    return step


def sharded_pca_annular(cube, angles, ncomp=5, fwhm=4.0, asize=4,
                        delta_rot=0.5, radius_int=0, n_segments=1,
                        max_frames_lib=200, mesh=None, collapse="median",
                        method="eigen", scaling=None):
    """Host geometry (``pca_annular``'s rules: PA thresholds, segment
    indices, per-frame library masks), then the sharded step; the host
    frame (vip_tpu sharded.py:182). Zero pixels are kept zero through the
    derotation only with a nonzero ``radius_int``, as ``pca_annular``
    does; vip_tpu keeps them zero at ``radius_int=0`` too, where its
    frame then differs from its ``pca_annular``'s outside the annuli."""
    from ..preproc.derotation import _define_annuli, _find_indices_adi
    from ..var.shapes import get_annulus_segments, resolve_n_segments

    if mesh is None:
        mesh = frame_mesh()
    n, y, x = cube.shape
    _check_frames(n, mesh)
    angles = np.asarray(angles.detach().cpu() if isinstance(
        angles, torch.Tensor) else angles, dtype=float)

    n_annuli = int((y / 2 - radius_int) / asize)
    seg_counts = resolve_n_segments(n_segments, n_annuli, asize)
    segments, masks, keffs = [], [], []
    for ann in range(n_annuli):
        pa_thr, inner_radius, _ = _define_annuli(
            angles, ann, n_annuli, fwhm, radius_int, asize, delta_rot,
            seg_counts[ann], False, True)
        indices = get_annulus_segments((y, x), inner_radius, asize,
                                       seg_counts[ann])
        if pa_thr != 0:
            mask = np.zeros((n, n), dtype=bool)
            sizes = np.zeros(n, dtype=int)
            for fr in range(n):
                idx = _find_indices_adi(angles, fr, pa_thr, truncate=True,
                                        max_frames=max_frames_lib)
                mask[fr, idx] = True
                sizes[fr] = len(idx)
        else:
            mask = np.ones((n, n), dtype=bool)
            sizes = np.full(n, n)
        for yy, xx in indices:
            segments.append((yy, xx))
            masks.append(mask)
            keffs.append(np.minimum(ncomp, np.minimum(sizes, len(yy))))

    fn = make_sharded_pca_annular(mesh, segments, ncomp, collapse=collapse,
                                  method=method, scaling=scaling,
                                  frame_shape=(y, x),
                                  mask_zeros=bool(radius_int))
    return _host(fn(shard_cube(_float(cube), mesh), shard_cube(angles, mesh),
                    shard_cube(np.stack(masks), mesh, spec=1),
                    shard_cube(np.stack(keffs), mesh, spec=1)))


def make_sharded_median_adi(mesh, axis="frames", collapse="median"):
    """Sharded full-frame median-ADI (vip_tpu sharded.py:250): the
    temporal median model runs row-sharded (all_to_all), the residual
    derotation frame-sharded, the final collapse reshards again.
    ``step(cube, angles)`` → the frame."""

    def step(cube, angles):
        cube_loc, ang_loc = _frames_and_angles(cube, angles, mesh)
        y, W = cube_loc.shape[1], mesh.size()
        if y % W:
            raise ValueError(f"y ({y}) must divide evenly over {W} devices "
                             "for the median reshard")
        full = all_to_all(cube_loc, mesh, 1, 0)
        med = all_gather(_median0(full, True), mesh)
        der = _derotate(cube_loc - med[None], ang_loc)
        return _collapse(der, mesh, collapse, cube_loc.shape[0] * W)

    return step


def _apply_resample(frames, R, g, h):
    """Each channel's exact-zoom operator (``preproc.rescaling.
    scale_fft_matrix``) on its frames (vip_tpu sharded.py:274): frames
    (z, n, i, i), R (z, o, i), g (z, o), h (z, i) → (z, n, o, o). One
    channel at a time: a batched product over all of a rank's channels
    may round otherwise with their number, and the joint PCA of an IFS
    sequence turns its PCs with that rounding."""
    out = []
    for f, r, gc, hc in zip(frames, R, g, h):
        corr = torch.einsum("i,nij,j->n", hc, f, hc)
        out.append(r @ f @ r.T - corr[:, None, None] * torch.outer(gc, gc))
    return torch.stack(out)


def make_sharded_pca_sdi_single(mesh, ncomp, axis="channels",
                                collapse="median", collapse_ifs="mean"):
    """Sharded ADI+mSDI single-step PCA (vip_tpu sharded.py:284), exact
    against ``pca(adimsdi='single', imlib2='vip-fft')``: the channels of
    the 4-d cube lie on the ranks; each rank zooms its channels to the
    common wavelength with their exact operators, the joint (z·n, p)
    library is one all_gather (its Gram, PCs and projection formed on
    every rank), the inverse zoom stays local, the channel collapse is an
    all_reduce (mean) or an all_to_all reshard (median), and the ADI stage
    derotates each rank's frame slab.

    ``step(cube4d, angles, A, gA, hA, B, gB, hB)`` → the frame, with the
    padded cube and the forward (A, gA, hA) and inverse (B, gB, hB)
    operators sharded along channels and ``angles`` replicated. Requires
    z % n_dev == 0 and n % n_dev == 0."""
    n_dev = mesh.size()
    if collapse not in ("mean", "median"):
        raise ValueError("sharded collapse supports 'mean' and 'median'")
    if collapse_ifs not in ("mean", "median"):
        raise ValueError("sharded collapse_ifs supports 'mean' and 'median'")

    def step(cube4d, angles, A, gA, hA, B, gB, hB):
        cube_loc = local_slab(cube4d, mesh)
        dev, dt = cube_loc.device, cube_loc.dtype
        A, gA, hA, B, gB, hB = (local_slab(v, mesh, device=dev, dtype=dt)
                                for v in (A, gA, hA, B, gB, hB))
        angles = replicated(angles, dev, dt)
        z_loc, n = cube_loc.shape[:2]
        resc = _apply_resample(cube_loc, A, gA, hA)
        y_pca = resc.shape[-1]
        resid = _pca_residual(resc.reshape(z_loc * n, y_pca * y_pca), ncomp,
                              mesh).reshape(z_loc, n, y_pca, y_pca)
        desc = _apply_resample(resid, B, gB, hB)
        y, x = desc.shape[-2:]

        # channel (IFS) collapse, then each rank's frame slab
        idx = mesh.get_local_rank()
        n_loc = n // n_dev
        if collapse_ifs == "median":
            # (z_loc, n, y, x) -> (z, n_loc, y, x): every rank gets all
            # channels of its own frames
            full = all_to_all(desc, mesh, 1, 0)
            fr_loc = _median0(full.reshape(-1, n_loc * y, x), True).reshape(
                n_loc, y, x)
        else:
            cube_adi = all_reduce(desc.sum(dim=0), mesh) / (z_loc * n_dev)
            fr_loc = cube_adi[idx * n_loc:(idx + 1) * n_loc]
        der = _derotate(fr_loc, angles[idx * n_loc:(idx + 1) * n_loc])
        return _collapse(der, mesh, collapse, n)

    return step


def _channel_resample_ops(dim, scale, crop=None):
    """The exact-zoom operator of one channel at frame size ``dim``, odd
    dims through ``frame_rescaling``'s embedding in an even frame, with
    an optional centred row crop to ``crop`` (vip_tpu sharded.py:405)."""
    from ..preproc.rescaling import scale_fft_matrix
    from ..var.shapes import get_square

    if dim % 2:
        R, g, h = scale_fft_matrix(dim + 1, float(scale))
        # the odd frame sits at [1:, 1:] of the even one, and the output
        # is cropped back: the operator drops row and column 0
        R, g, h = R[1:, 1:], g[1:], h[1:]
    else:
        R, g, h = scale_fft_matrix(dim, float(scale))
    if crop is not None and crop < dim:
        _, y0, _ = get_square(np.zeros((dim, dim)), crop, (dim - 1) / 2.,
                              (dim - 1) / 2., position=True, verbose=False)
        # get_square grows the size by 1 on a parity mismatch
        size = crop + 1 if (dim % 2) != (crop % 2) else crop
        R, g = R[y0:y0 + size], g[y0:y0 + size]
    return R, g, h


def sharded_pca_sdi_single(cube, angles, scal_list, ncomp=2, mesh=None,
                           collapse="median", collapse_ifs="mean",
                           crop_ifs=True):
    """Multi-device ``pca(adimsdi='single')`` (vip_tpu sharded.py:433):
    reflect padding to ceil(max_scale · y), each channel's exact forward
    zoom (cropped back to y with ``crop_ifs``), one joint PCA of all z·n
    frames, the inverse zoom and crop, the channel collapse, derotation
    and the final collapse. Each rank pads only its own channels, on its
    device, and builds only their operators (host float64). The host
    frame."""
    if mesh is None:
        mesh = frame_mesh(axis_name="channels")
    n_dev = mesh.size()
    z, n, y_in, x_in = cube.shape
    if y_in != x_in:
        raise ValueError("sharded SDI requires square frames")
    if z % n_dev or n % n_dev:
        raise ValueError(f"z ({z}) and n ({n}) must divide evenly over "
                         f"{n_dev} devices")
    scal = np.asarray(scal_list, float)

    # reflect padding (vip_tpu rescaling.py's forward branch) of this
    # rank's channels; values through float32 as scale_fft embeds them
    cube_loc = local_slab(_float(cube), mesh)
    max_sc = float(np.max(scal))
    if max_sc > 1:
        new_y = int(np.ceil(max_sc * y_in))
        if (new_y - y_in) % 2 != 0:
            new_y += 1
        p = (new_y - y_in) // 2
        cube_loc = torch.nn.functional.pad(cube_loc, (p, p, p, p),
                                           mode="reflect")
    cube_loc = cube_loc.to(torch.float32).to(cube_loc.dtype)
    y_pad = cube_loc.shape[-1]

    # this rank's channels' operators only, in the cube's dtype (a float64
    # cube on a card keeps float64 operators)
    z_loc = cube_loc.shape[0]
    scal_loc = scal[mesh.get_local_rank() * z_loc:(mesh.get_local_rank() + 1) * z_loc]
    fwd = [_channel_resample_ops(y_pad, s, crop=y_in if crop_ifs else None)
           for s in scal_loc]
    y_pca = fwd[0][0].shape[0]
    inv = [_channel_resample_ops(y_pca, 1.0 / s,
                                 crop=y_in if y_pca > y_in else None)
           for s in scal_loc]
    ops = [np.stack([f[i] for f in fwd]) for i in range(3)] + \
        [np.stack([iv[i] for iv in inv]) for i in range(3)]
    ops = [from_local(torch.as_tensor(o, dtype=cube_loc.dtype,
                                      device=cube_loc.device), mesh)
           for o in ops]

    fn = make_sharded_pca_sdi_single(mesh, ncomp, axis=mesh.mesh_dim_names[0],
                                     collapse=collapse,
                                     collapse_ifs=collapse_ifs)
    return _host(fn(from_local(cube_loc, mesh),
                    np.asarray(angles.detach().cpu() if isinstance(
                        angles, torch.Tensor) else angles, float), *ops))


# ---------------------------------------------------------------------------
# The streamed (out-of-core) PCA with the PIXEL axis sharded (vip_tpu
# sharded.py:458-576). Every streamed block is split over the mesh along
# its pixels, each rank holds 1/n_dev of every block, of the basis and of
# the running mean, and the only traffic of the merge is one all_reduce of
# the small (k+m+1)² Gram a block. Pass 2 reshards the residual block
# pixels → frames (all_to_all) so the derotation stays frame-local, then
# collapses with a validity mask, so a ragged tail batch runs the same
# step. Zero padding of the pixel axis to a mesh multiple is exact (zero
# pixels add nothing to the Gram, the mean or the projection).
# ---------------------------------------------------------------------------


def make_sharded_incremental_merge(mesh, keep, m_pad, axis=None):
    """One pixel-sharded merge-and-truncate step of the streamed SVD
    (vip_tpu sharded.py:480): ``step(basis, blk, mean, count, nvalid)``
    with basis (keep, npx_pad) and blk (m_pad, npx_pad) sharded along
    pixels (dim 1), blk's rows past ``nvalid`` zero, mean (npx_pad,)
    sharded, and ``count``/``nvalid`` numbers. Returns (basis, mean)
    sharded and the new count; ``utils_pca._incremental_merge_svd``'s
    numbers up to the order of the sums."""

    def step(basis, blk, mean, count, nvalid):
        basis_loc = local_slab(basis, mesh, dim=1)
        blk_loc = local_slab(blk, mesh, dim=1)
        mean_loc = local_slab(mean, mesh)
        count, nvalid = float(count), float(nvalid)
        new_count = count + nvalid
        blk_mean = blk_loc.sum(dim=0) / nvalid     # pad rows are zero
        mean_corr = math.sqrt(count * nvalid / new_count) \
            * (blk_mean - mean_loc)
        valid = (torch.arange(m_pad, device=blk_loc.device) < nvalid)[:, None]
        centered = torch.where(valid, blk_loc - blk_mean, 0.0)
        stack = torch.cat([basis_loc, centered, mean_corr[None]])
        _, U = torch.linalg.eigh(all_reduce(stack @ stack.T, mesh))
        top = U[:, -keep:].flip(1)                 # top-keep, descending
        new_mean = (count * mean_loc + nvalid * blk_mean) / new_count
        return (from_local(top.T @ stack, mesh, 1),
                from_local(new_mean, mesh, 0), new_count)

    return step


def make_sharded_incremental_normalize(mesh, axis=None):
    """Row-normalize the pixel-sharded basis (vip_tpu sharded.py:514):
    the rows' norms are an all_reduce of the local sums of squares."""

    def step(basis):
        basis_loc = local_slab(basis, mesh, dim=1)
        norms = torch.sqrt(all_reduce((basis_loc ** 2).sum(dim=1),
                                      mesh))[:, None]
        return from_local(basis_loc / torch.where(norms == 0, 1.0, norms),
                          mesh, 1)

    return step


def make_sharded_incremental_pass2(mesh, shape, npx, collapse="median",
                                   axis=None):
    """Pass 2 of one block (vip_tpu sharded.py:529): pixel-sharded
    projection and subtraction, an all_to_all reshard to frames for the
    local derotation, and the collapse of the batch's valid frames.

    ``step(blk, mean, V, angles_pad, nvalid)`` → the (y, x) frame, with
    blk/mean/V sharded along pixels and ``angles_pad`` (m_pad,)
    replicated, its entries past ``nvalid`` padding. The padded frames go
    through the rotation and are masked out of the collapse."""
    y, x = shape
    if collapse not in ("median", "mean", "sum"):
        raise ValueError("sharded pass-2 collapse supports "
                         "'median'/'mean'/'sum'")

    def step(blk, mean, V, angles_pad, nvalid):
        blk_loc = local_slab(blk, mesh, dim=1)
        M = blk_loc - local_slab(mean, mesh)
        V_loc = local_slab(V, mesh, dim=1)
        coef = all_reduce(M @ V_loc.T, mesh)          # (m_pad, k)
        resid_loc = M - coef @ V_loc
        # pixels → frames: each rank derotates m_pad / n_dev whole frames
        frames = all_to_all(resid_loc, mesh, 0, 1)[:, :npx].reshape(-1, y, x)
        m_loc = frames.shape[0]
        idx = mesh.get_local_rank()
        ang = replicated(angles_pad, frames.device, frames.dtype)
        der = _derotate(frames, ang[idx * m_loc:(idx + 1) * m_loc])
        # the batch's collapse needs every frame of a pixel: one gather
        der_all = all_gather(der, mesh)
        valid = (torch.arange(der_all.shape[0], device=der_all.device)
                 < float(nvalid))[:, None, None]
        if collapse == "median":
            return _median0(torch.where(valid, der_all, torch.nan), False)
        s = torch.where(valid, der_all, 0.0).sum(dim=0)
        return s if collapse == "sum" else s / float(nvalid)

    return step

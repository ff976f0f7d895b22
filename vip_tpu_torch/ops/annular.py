"""Batched per-frame PCA of annulus segments (port of
``vip_tpu.ops.annular``).

VIP runs annular PCA one frame per process, each with its own library of
frames (PA threshold, then the ΔPA truncation) and a small SVD. Here all
frames of a segment are one batched computation. The principal components
of a library are the top eigenvectors of libᵀlib = Σ_rows outer(row, row),
so zeroing the rows outside a frame's library leaves them unchanged: the
ragged libraries become fixed-shape masks or zero-weight padding. Frames
whose library is smaller than ``ncomp`` keep only their first ``k_eff``
components (VIP's ``min(ncomp, lib_rows)``).

Two formulations:

- :func:`batched_pca_patch_residuals`: each frame's masked library in
  pixel space (an (n, n, p) batch; the host path below 128 frames, and
  wherever the PCs themselves are needed).
- :func:`batched_pca_patch_residuals_gram`: the same residuals from one
  segment Gram matrix G = M Mᵀ and per-frame (L, L) sub-Grams, L the padded
  library size, by eigh or by a subspace iteration run to convergence in
  float64 (``ops.linalg._subspace_topk``); :func:`resident_annulus_update`
  does the same for many segments at once, with the segment gathers and
  the residual scatters of the device-resident path.

All of it is ``torch.matmul`` and ``torch.linalg`` on the tensors' device
(vip_tpu has no Pallas kernel here). Each factorization of the frames'
libraries is a span (``config.timing``) that counts the libraries it
factors: ``annular.eigh`` or ``annular.svd`` in :func:`_masked_top_v`,
``annular.eigh`` or ``annular.subspace`` in :func:`_library_topk` (both
Gram-space paths).
"""

import torch

from ..config.timing import annotate_trace
from .linalg import _subspace_topk, svd

__all__ = ["batched_pca_patch_residuals",
           "batched_pca_patch_residuals_gram",
           "resident_annulus_update"]


def _masked_top_v(lib, ncomp, method):
    """Top-``ncomp`` right singular vectors of a batch of (possibly
    zero-row-padded) libraries (..., rows, p), guarded against division by
    zero singular values (vip_tpu annular.py:30)."""
    libraries = lib.shape[:-2].numel()
    if method == "eigen":
        C = lib @ lib.transpose(-1, -2)
        with annotate_trace("annular.eigh", libraries):
            e, EV = torch.linalg.eigh(C)
        V = (EV.transpose(-1, -2) @ lib).flip(-2)
        S = torch.sqrt(torch.abs(e)).flip(-1)
        S = torch.where(S == 0, 1.0, S)
        return (V / S[..., None])[..., :ncomp, :]
    # 'lapack' and the fallback of every other method
    with annotate_trace("annular.svd", libraries):
        U2 = svd(lib.transpose(-1, -2))[0]
    return U2[..., :ncomp].transpose(-1, -2)


def batched_pca_patch_residuals(matrix, matrix_emp, lib_masks, ncomp,
                                method="lapack", matrix_ref=None,
                                k_eff=None):
    """Per-frame PCA residuals over a segment matrix (vip_tpu
    annular.py:48).

    matrix, matrix_emp : (n, p) segment pixels per frame (scaled), and the
        signal-subtracted version (the same tensor without ``cube_sig``).
    lib_masks : (n, n) bool; row f marks the frames of f's library.
    ncomp : max number of PCs.
    matrix_ref : (m, p) or None; RDI rows prepended to every library.
    k_eff : (n,) int or None; per-frame number of PCs kept.

    Returns (residuals (n, p), V_all (n, ncomp, p)), the surplus PC rows of
    ``V_all`` zeroed.
    """
    n = matrix.shape[0]
    masks = torch.as_tensor(lib_masks, device=matrix.device)
    lib = matrix_emp[None] * masks[:, :, None].to(matrix.dtype)
    if matrix_ref is not None:
        lib = torch.cat([matrix_ref[None].expand(n, -1, -1), lib], dim=1)
    V = _masked_top_v(lib, ncomp, method)
    k = torch.full((n,), ncomp, device=matrix.device) if k_eff is None \
        else torch.as_tensor(k_eff, device=matrix.device)
    keep = torch.arange(V.shape[1], device=matrix.device)[None] < k[:, None]
    V = torch.where(keep[:, :, None], V, 0.0)
    transformed = torch.einsum("np,nkp->nk", matrix_emp, V)
    reconstructed = torch.einsum("nk,nkp->np", transformed, V)
    return matrix - reconstructed, V


# Bytes of library Grams that resident_annulus_update factors as one
# batch. The subspace iteration's peak is ~4-5 times the batch's Grams
# (26.2 GB for 5.2 GB of them at 512 frames, 32 annuli, on an H100).
RESIDENT_BATCH_BYTES = 8 << 30


def _gather_lib_grams(G, lib_idx):
    """All per-frame library Grams ``Gm[f] = G[idx_f][:, idx_f]`` as one
    (n, L, L) tensor (vip_tpu annular.py:204). vip_tpu built it from two
    row gathers to dodge a slow TPU lowering; here it is one advanced
    index, the same values."""
    return G[lib_idx[:, :, None], lib_idx[:, None, :]]


def batched_pca_patch_residuals_gram(matrix, matrix_emp, lib_idx, lib_w,
                                     ncomp, k_eff=None, method="eigh",
                                     sketch=None):
    """The residuals of :func:`batched_pca_patch_residuals`, computed in
    Gram space (vip_tpu annular.py:129).

    The segment Gram G = M_emp M_empᵀ is formed once; frame f's library
    Gram is the (L, L) gather G[idx_f, idx_f] weighted by ``lib_w`` (padding
    rows weigh 0); its projection coefficients come from the Gram column
    G[idx_f, f]; and all reconstructions are one (n, n) x (n, p) product
    ``matrix - C @ matrix_emp``, row f of C holding frame f's library
    weights.

    matrix, matrix_emp : (n, p). lib_idx : (n, L) int, padded arbitrarily.
    lib_w : (n, L), 1 for library rows and 0 for padding. ncomp : max PCs.
    k_eff : (n,) int or None. method : 'eigh' (exact per-frame eigh, in
    the matrices' dtype) or 'subspace' (``linalg._subspace_topk``, started
    from ``sketch``; the Gram, the projection and
    the reconstruction then run in float64 too, since the coefficients C
    of nearly collinear library frames cancel, and float32 would lose
    the accuracy the converged components bring). Returns the residuals
    (n, p) in ``matrix``'s dtype.
    """
    n = matrix.shape[0]
    dev = matrix.device
    work = _work_dtype(method, matrix.dtype)
    emp = matrix_emp.to(work)
    lib_idx = torch.as_tensor(lib_idx, device=dev).long()
    w = torch.as_tensor(lib_w, device=dev, dtype=work)
    k = torch.full((n,), ncomp, device=dev) if k_eff is None \
        else torch.as_tensor(k_eff, device=dev)
    G = emp @ emp.T                                              # (n, n)
    Gm = _gather_lib_grams(G, lib_idx) * (w[:, :, None] * w[:, None, :])
    e_top, U_top = _library_topk(Gm, ncomp, method, sketch, 8)
    return _gram_residuals(matrix, emp, G, lib_idx, w, e_top, U_top, k)


def _work_dtype(method, dtype):
    return torch.float64 if method == "subspace" else dtype


def _library_topk(Gm, ncomp, method, sketch, oversample):
    """The top ``ncomp`` eigenpairs (descending) of a batch of library
    Grams (..., L, L), inside the span that counts them."""
    count = Gm.shape[:-2].numel()
    if method == "subspace":
        with annotate_trace("annular.subspace", count):
            return _subspace_topk(Gm, ncomp, oversample=oversample,
                                  sketch=sketch)[:2]
    with annotate_trace("annular.eigh", count):
        e, EV = torch.linalg.eigh(Gm)                            # ascending
    return e.flip(-1)[..., :ncomp], EV.flip(-1)[..., :ncomp]


def _gram_residuals(matrix, emp, G, lib_idx, w, e_top, U_top, k):
    """``matrix - C @ emp`` of :func:`batched_pca_patch_residuals_gram`,
    from the segment Gram G, the padded libraries (lib_idx, w), their top
    eigenpairs and the per-frame number of components k; in ``matrix``'s
    dtype."""
    n = matrix.shape[0]
    dev = matrix.device
    U_top = U_top * w[:, :, None]                                # (n, L, K)
    s = torch.sqrt(torch.abs(e_top))
    s = torch.where(s == 0, 1.0, s)
    Us = U_top / s[:, None, :]
    # transformed_k = curr_emp · V_k = (U_k/s_k) · (G[idx_f, f] * w)
    g_col = G[lib_idx, torch.arange(n, device=dev)[:, None]] * w  # (n, L)
    t = torch.einsum("nlk,nl->nk", Us, g_col)
    t = torch.where(torch.arange(t.shape[1], device=dev)[None] < k[:, None],
                    t, 0.0)
    c_all = torch.einsum("nlk,nk->nl", Us, t)                    # (n, L)
    C = torch.zeros((n, n), dtype=G.dtype, device=dev)
    C.index_put_((torch.arange(n, device=dev)[:, None].expand_as(lib_idx),
                  lib_idx), c_all, accumulate=True)
    return (matrix.to(G.dtype) - C @ emp).to(matrix.dtype)


def resident_annulus_update(cube, cube_out, flat_idx, colmask, lib_idx,
                            lib_w, k_eff, ncomp, method="eigh", sketch=None,
                            oversample=8):
    """Annulus segments of the device-resident annular PCA (vip_tpu
    annular.py:236): gather each segment's pixels, run the Gram-path PCA,
    write the residuals into ``cube_out`` (in place; also returned).

    One segment: ``flat_idx`` and ``colmask`` (p,), lib_idx and lib_w
    (n, L), k_eff (n,). Several: ``flat_idx`` and ``colmask`` sequences of
    S segments, lib_idx and lib_w (S, n, L), k_eff (S, n); the libraries of
    the segments are then factored as one batch (one subspace iteration
    for all: few launches and few reads back, whatever S), in groups of
    at most ``RESIDENT_BATCH_BYTES`` of Grams, and each segment's
    residuals are written in turn.

    ``flat_idx`` holds flattened pixel indices (yy * x + xx); entries
    ≥ y*x are padding, and ``colmask`` zeroes their columns. vip_tpu
    clamped such entries on the gather and dropped them on the scatter;
    torch raises on an out-of-range index, so they are clamped here and
    sliced off before the scatter. The residuals are computed from
    ``cube`` and written segment after segment, so the later annulus wins
    where the last annulus overlaps the one before it, as the host path
    does.
    """
    n, y, x = cube.shape
    dev = cube.device
    lib_idx = torch.as_tensor(lib_idx, device=dev).long()
    if not isinstance(flat_idx, (list, tuple)):
        flat_idx, colmask = [flat_idx], [colmask]
        lib_idx, lib_w, k_eff = lib_idx[None], [lib_w], [k_eff]
    work = _work_dtype(method, cube.dtype)
    w = torch.stack([torch.as_tensor(v, device=dev, dtype=work)
                     for v in lib_w])                            # (S, n, L)
    flat_idx = [torch.as_tensor(f, device=dev).long() for f in flat_idx]
    L = lib_idx.shape[-1]
    per_seg = n * L * L * torch.finfo(work).bits // 8
    group = max(1, RESIDENT_BATCH_BYTES // per_seg)
    for g0 in range(0, len(flat_idx), group):
        span = range(g0, min(g0 + group, len(flat_idx)))
        libs = torch.empty((len(span), n, L, L), dtype=work, device=dev)
        segs = []
        for i, s in enumerate(span):
            cmask = torch.as_tensor(colmask[s], device=dev, dtype=cube.dtype)
            pix = flat_idx[s].clamp(max=y * x - 1)
            seg = cube.reshape(n, y * x)[:, pix] * cmask[None, :]
            emp = seg.to(work)
            G = emp @ emp.T                                      # (n, n)
            torch.mul(_gather_lib_grams(G, lib_idx[s]),
                      w[s, :, :, None] * w[s, :, None, :], out=libs[i])
            segs.append((seg, emp, G))
        e_top, U_top = _library_topk(libs, ncomp, method, sketch,
                                     oversample)
        del libs
        for i, s in enumerate(span):
            seg, emp, G = segs[i]
            k = torch.full((n,), ncomp, device=dev) if k_eff[s] is None \
                else torch.as_tensor(k_eff[s], device=dev)
            res = _gram_residuals(seg, emp, G, lib_idx[s], w[s], e_top[i],
                                  U_top[i], k)
            valid = flat_idx[s] < y * x
            cube_out.view(n, y * x)[:, flat_idx[s][valid]] = res[:, valid]
    return cube_out

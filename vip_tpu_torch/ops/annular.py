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
  library size, by eigh or by subspace iteration
  (:func:`_subspace_topk`); :func:`resident_annulus_update` wraps it with
  the segment gather and the residual scatter of the device-resident path.

All of it is ``torch.matmul`` and ``torch.linalg`` on the tensors' device
(vip_tpu has no Pallas kernel here).
"""

import torch

__all__ = ["batched_pca_patch_residuals",
           "batched_pca_patch_residuals_gram",
           "resident_annulus_update"]


def _masked_top_v(lib, ncomp, method):
    """Top-``ncomp`` right singular vectors of a batch of (possibly
    zero-row-padded) libraries (..., rows, p), guarded against division by
    zero singular values (vip_tpu annular.py:30)."""
    if method == "eigen":
        C = lib @ lib.transpose(-1, -2)
        e, EV = torch.linalg.eigh(C)
        V = (EV.transpose(-1, -2) @ lib).flip(-2)
        S = torch.sqrt(torch.abs(e)).flip(-1)
        S = torch.where(S == 0, 1.0, S)
        return (V / S[..., None])[..., :ncomp, :]
    # 'lapack' and the fallback of every other method
    U2 = torch.linalg.svd(lib.transpose(-1, -2), full_matrices=False)[0]
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


def _default_sketch(L, m, dtype, device):
    """The subspace iteration's start when none is given: a Gaussian (L, m)
    draw from a ``torch.Generator`` seeded with 7 (vip_tpu draws from
    ``jax.random.PRNGKey(7)``; the two generators give other numbers)."""
    gen = torch.Generator(device=device).manual_seed(7)
    return torch.randn((L, m), generator=gen, dtype=dtype, device=device)


def _orth(B):
    """Q of the thin Householder QR of a batch of tall (..., L, m) blocks:
    ``torch.geqrf``, then the m reflectors applied to the first m columns
    of the identity, as LAPACK's orgqr does. ``torch.linalg.qr`` forms Q
    with one cuSOLVER orgqr call per matrix on CUDA (49.4 ms for
    (1000, 200, 18) on an H100, against 1.39 ms here; PERF.md); geqrf is one
    batched call."""
    a, tau = torch.geqrf(B)
    L, m = B.shape[-2:]
    eye = torch.eye(L, m, dtype=B.dtype, device=B.device)
    V = a.tril(-1) + eye                      # unit lower trapezoidal
    Q = eye.expand_as(B).clone()
    for j in reversed(range(m)):
        v = V[..., :, j:j + 1]
        Q = Q - (tau[..., j, None, None] * v) @ (v.transpose(-1, -2) @ Q)
    return Q


def _subspace_topk(Gm, ncomp, n_iter=30, oversample=8, sketch=None):
    """Top-``ncomp`` eigenpairs of a batch of symmetric PSD Grams
    (..., L, L) by blocked subspace iteration with a QR every step, then
    Rayleigh-Ritz (vip_tpu annular.py:89), the Gram-space analogue of
    VIP's randomized SVD with 30 power steps. The QR is :func:`_orth`.

    ``sketch`` is the (L, min(L, ncomp + oversample)) starting block,
    shared by every matrix of the batch; None draws it with
    :func:`_default_sketch`. Returns (e_top (..., ncomp), U_top
    (..., L, ncomp)), descending.
    """
    L = Gm.shape[-1]
    m = min(L, ncomp + oversample)
    if sketch is None:
        sketch = _default_sketch(L, m, Gm.dtype, Gm.device)
    elif tuple(sketch.shape) != (L, m):
        raise ValueError(f"sketch must have shape {(L, m)}, got "
                         f"{tuple(sketch.shape)}")
    R = sketch.to(Gm.device, Gm.dtype)
    # normalize to keep powers of the spectral radius in range
    scale = torch.clamp(Gm.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
    A = Gm / scale
    # a QR every step: under raw powering the subdominant columns decay
    # like (lam_j/lam_1)^q and a Gram-based orthonormalization collapses
    B = _orth(A @ R)
    for _ in range(n_iter):
        B = _orth(A @ B)
    T = B.transpose(-1, -2) @ (A @ B)
    T = 0.5 * (T + T.transpose(-1, -2))
    e, W = torch.linalg.eigh(T)
    e_top = e.flip(-1)[..., :ncomp] * scale[..., 0]
    U_top = (B @ W).flip(-1)[..., :ncomp]
    return e_top, U_top


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
    k_eff : (n,) int or None. method : 'eigh' (exact per-frame eigh) or
    'subspace' (:func:`_subspace_topk`, started from ``sketch``).
    Returns the residuals (n, p).
    """
    n = matrix.shape[0]
    dev = matrix.device
    lib_idx = torch.as_tensor(lib_idx, device=dev).long()
    w = torch.as_tensor(lib_w, device=dev, dtype=matrix.dtype)
    k = torch.full((n,), ncomp, device=dev) if k_eff is None \
        else torch.as_tensor(k_eff, device=dev)

    G = matrix_emp @ matrix_emp.T                                # (n, n)
    Gm = _gather_lib_grams(G, lib_idx) * (w[:, :, None] * w[:, None, :])
    if method == "subspace":
        e_top, U_top = _subspace_topk(Gm, ncomp, sketch=sketch)
    else:
        e, EV = torch.linalg.eigh(Gm)                            # ascending
        e_top = e.flip(-1)[:, :ncomp]
        U_top = EV.flip(-1)[:, :, :ncomp]
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
    C = torch.zeros((n, n), dtype=matrix.dtype, device=dev)
    C.index_put_((torch.arange(n, device=dev)[:, None].expand_as(lib_idx),
                  lib_idx), c_all, accumulate=True)
    return matrix - C @ matrix_emp


def resident_annulus_update(cube, cube_out, flat_idx, colmask, lib_idx,
                            lib_w, k_eff, ncomp, method="eigh", sketch=None):
    """One annulus segment of the device-resident annular PCA (vip_tpu
    annular.py:236): gather the segment's pixels, run the Gram-path PCA,
    write the residuals into ``cube_out`` (in place; also returned).

    ``flat_idx`` holds flattened pixel indices (yy * x + xx); entries
    ≥ y*x are padding, and ``colmask`` zeroes their columns. vip_tpu
    clamped such entries on the gather and dropped them on the scatter;
    torch raises on an out-of-range index, so they are clamped here and
    sliced off before the scatter. The assignment lets the later annulus
    win where the last annulus overlaps the one before it, as the host
    path does.
    """
    n, y, x = cube.shape
    dev = cube.device
    flat_idx = torch.as_tensor(flat_idx, device=dev).long()
    colmask = torch.as_tensor(colmask, device=dev, dtype=cube.dtype)
    seg = cube.reshape(n, y * x)[:, flat_idx.clamp(max=y * x - 1)] \
        * colmask[None, :]
    res = batched_pca_patch_residuals_gram(seg, seg, lib_idx, lib_w, ncomp,
                                           k_eff=k_eff, method=method,
                                           sketch=sketch)
    valid = flat_idx < y * x
    cube_out.view(n, y * x)[:, flat_idx[valid]] = res[:, valid]
    return cube_out

"""Non-negative matrix factorization by multiplicative updates (port of
``vip_tpu.ops.nmf``).

sklearn's ``NMF(solver='mu')`` semantics, as vip_tpu has them: NNDSVD(a/ar)
or random initialization from the SVD, Frobenius multiplicative updates
with sklearn's epsilon guard (float32 eps in both precisions), and its
stopping rule, checked every 10 iterations: stop when
``(previous error - error) / initial error < tol``. The iterations are a
host loop over torch matmuls on the data's device, with one host sync
every 10 iterations.

vip_tpu draws the nndsvdar fill and the random init from
``jax.random.PRNGKey(0)`` (vip_tpu ops/nmf.py:74-76, 149-154, 219-221),
which torch cannot reproduce: here the draw is the keyword-only ``draws``
argument, a pair of standard-normal arrays shaped like W and H, or is made
with the keyword-only ``generator`` (default: a ``torch.Generator`` seeded
with 0 on the data's device).
"""

import numpy as np
import torch

from ..config.device import as_tensor
from .linalg import svd

EPSILON = float(np.finfo(np.float32).eps)

__all__ = ["nndsvd_init", "nmf_fit", "nmf_transform",
           "nmf_patch_batched"]


def _normal_pair(draws, shape_w, shape_h, dtype, device, generator):
    """Standard-normal draws shaped like W and H: ``draws`` as given, else
    from ``generator`` (a fresh one seeded with 0 when None)."""
    if draws is not None:
        zw, zh = draws
        zw = as_tensor(zw, device, dtype)
        zh = as_tensor(zh, device, dtype)
        if tuple(zw.shape) != tuple(shape_w) \
                or tuple(zh.shape) != tuple(shape_h):
            raise ValueError(f"draws must have shapes {tuple(shape_w)} and "
                             f"{tuple(shape_h)}, got {tuple(zw.shape)} and "
                             f"{tuple(zh.shape)}")
        return zw, zh
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    zw = torch.randn(tuple(shape_w), generator=generator, dtype=dtype,
                     device=device)
    zh = torch.randn(tuple(shape_h), generator=generator, dtype=dtype,
                     device=device)
    return zw, zh


def _top_svd(X, k):
    """Top-``k`` singular triplets (U (.., m, k), S (.., k), Vh (.., k, p)).

    One matrix: :func:`ops.linalg.svd`, of the (m, m) factor R of Xᵀ = QR
    when p > 4m (the full-frame libraries). A batch of libraries (the
    annular fits, one a frame): the eigenpairs of the (m, m) Grams X Xᵀ,
    V = Uᵀ X / S; torch runs a batched SVD or eigh of matrices over 32
    rows as one cuSOLVER call per matrix, and eigh is the cheaper call."""
    if X.ndim == 3:
        e, EV = torch.linalg.eigh(X @ X.transpose(-1, -2))
        U = EV.flip(-1)[..., :k]
        S = torch.sqrt(e.flip(-1)[..., :k].clamp(min=0))
        Vh = (U.transpose(-1, -2) @ X) / torch.where(S == 0, 1.0, S)[..., None]
        return U, S, torch.where(S[..., None] == 0, 0.0, Vh)
    m, p = X.shape
    if p > 4 * m:
        Q, R = torch.linalg.qr(X.T)
        W, S, Uh = svd(R)
        return Uh.T[:, :k], S[:k], (Q @ W).T[:k]
    U, S, Vh = svd(X)
    return U[:, :k], S[:k], Vh[:k]


def _nndsvd_factors(X, n_components):
    """NNDSVD's W and H before the zero fill, for a matrix or a batch of
    matrices (..., m, p): the first pair from |U_0|, |V_0|, every other
    pair from the larger of the positive and negative parts of (U_j,
    V_j), all columns at once. Invariant to the signs of the singular
    vectors."""
    U, S, V = _top_svd(X, n_components)
    x, y = U, V.transpose(-1, -2)          # (.., m, k), (.., p, k)
    x_p, y_p = x.clamp(min=0), y.clamp(min=0)
    x_n, y_n = (-x).clamp(min=0), (-y).clamp(min=0)
    x_p_nrm, y_p_nrm = x_p.norm(dim=-2), y_p.norm(dim=-2)
    x_n_nrm, y_n_nrm = x_n.norm(dim=-2), y_n.norm(dim=-2)
    m_p, m_n = x_p_nrm * y_p_nrm, x_n_nrm * y_n_nrm
    pos = m_p > m_n

    def unit(v, nrm):
        return v / torch.where(nrm == 0, 1.0, nrm)[..., None, :]

    u = torch.where(pos[..., None, :], unit(x_p, x_p_nrm), unit(x_n, x_n_nrm))
    v = torch.where(pos[..., None, :], unit(y_p, y_p_nrm), unit(y_n, y_n_nrm))
    lbd = torch.sqrt(S * torch.where(pos, m_p, m_n))
    W = lbd[..., None, :] * u
    H = (lbd[..., None, :] * v).transpose(-1, -2)
    s0 = torch.sqrt(S[..., 0])[..., None]
    W[..., :, 0] = s0 * x[..., :, 0].abs()
    H[..., 0, :] = s0 * y[..., :, 0].abs()
    eps = 1e-6
    W = torch.where(W < eps, 0.0, W)
    H = torch.where(H < eps, 0.0, H)
    return W, H


def nndsvd_init(X, n_components, variant="nndsvda", *, draws=None,
                generator=None):
    """NNDSVD initialization (sklearn ``_initialize_nmf``; vip_tpu
    ops/nmf.py:23). 'nndsvda' fills zeros with the mean of X, 'nndsvdar'
    with |mean · N(0, 1) / 100| from ``draws``/``generator``."""
    W, H = _nndsvd_factors(X, n_components)
    if variant == "nndsvda":
        avg = X.mean()
        W = torch.where(W == 0, avg, W)
        H = torch.where(H == 0, avg, H)
    elif variant == "nndsvdar":
        avg = X.mean()
        zw, zh = _normal_pair(draws, W.shape, H.shape, X.dtype, X.device,
                              generator)
        W = torch.where(W == 0, (avg * zw / 100).abs(), W)
        H = torch.where(H == 0, (avg * zh / 100).abs(), H)
    return W, H


def _mu_update_w(X, W, H):
    num = X @ H.transpose(-1, -2)
    den = W @ (H @ H.transpose(-1, -2))
    den = torch.where(den == 0, EPSILON, den)
    return W * (num / den)


def _mu_update_h(X, W, H):
    Wt = W.transpose(-1, -2)
    num = Wt @ X
    den = (Wt @ W) @ H
    den = torch.where(den == 0, EPSILON, den)
    return H * (num / den)


def _frob_err(X, W, H):
    """Frobenius norm of X − W H over the last two axes."""
    return torch.linalg.matrix_norm(X - W @ H)


def _nmf_mu(X, W, H, max_iter=100, tol=1e-4, update_H=True):
    """Multiplicative updates from (W, H) with sklearn's stopping rule,
    checked every 10 iterations (vip_tpu ops/nmf.py:91). Returns
    (W, H, n_iter)."""
    err_init = _frob_err(X, W, H)
    prev = err_init
    it = 0
    while it < max_iter:
        for _ in range(min(10, max_iter - it)):
            W = _mu_update_w(X, W, H)
            if update_H:
                H = _mu_update_h(X, W, H)
        it += min(10, max_iter - it)
        err = _frob_err(X, W, H)
        if bool((prev - err) / err_init < tol):
            break
        prev = err
    return W, H, it


def nmf_fit(X, n_components, max_iter=100, tol=1e-4, init="nndsvda", *,
            draws=None, generator=None):
    """Fit X ≈ W H with W, H ≥ 0 (vip_tpu ops/nmf.py:142). Returns
    (W, H, n_iter). ``draws``/``generator`` feed 'nndsvdar' and 'random'
    (sklearn's random init: sqrt(mean(X) / k) · |N(0, 1)|)."""
    X = as_tensor(X)
    k = int(n_components)
    if init in ("nndsvd", "nndsvda", "nndsvdar"):
        W, H = nndsvd_init(X, k, variant=init, draws=draws,
                           generator=generator)
    elif init == "random":
        avg = torch.sqrt(X.mean() / k)
        zw, zh = _normal_pair(draws, (X.shape[0], k), (k, X.shape[1]),
                              X.dtype, X.device, generator)
        W, H = (avg * zw).abs(), (avg * zh).abs()
    else:
        raise ValueError(f"init {init!r} not recognized")
    return _nmf_mu(X, W, H, int(max_iter), tol, update_H=True)


def nmf_transform(X, H, max_iter=100, tol=1e-4):
    """Project X onto fixed components H (sklearn ``NMF.transform``: W
    starts at sqrt(mean(X) / k), multiplicative updates of W alone;
    vip_tpu ops/nmf.py:337)."""
    X = as_tensor(X)
    H = as_tensor(H, X.device, X.dtype)
    k = H.shape[0]
    avg = torch.sqrt(X.mean().clamp(min=0) / k)
    W0 = avg.expand(X.shape[0], k).clone()
    return _nmf_mu(X, W0, H, int(max_iter), tol, update_H=False)[0]


def _nndsvd_init_masked(X, row_valid, n_components, variant, draws,
                        generator):
    """:func:`nndsvd_init` on a batch of zero-row-padded libraries
    (vip_tpu ops/nmf.py:159): zero rows leave the SVD unchanged, the mean
    counts the valid rows only, and padding rows of W stay exactly zero
    (a zero row of W is neutral in every update). 'nndsvdar' uses one
    (L, k), (k, p) draw for every library, as vip_tpu's vmapped
    ``PRNGKey(0)`` does."""
    W, H = _nndsvd_factors(X, n_components)
    n_valid = row_valid.sum(dim=1).clamp(min=1)
    avg = (X.sum(dim=(1, 2)) / (n_valid * X.shape[2]))[:, None, None]
    wrow = row_valid[:, :, None].bool()
    if variant == "nndsvda":
        W = torch.where((W == 0) & wrow, avg, W)
        H = torch.where(H == 0, avg, H)
    elif variant == "nndsvdar":
        zw, zh = _normal_pair(draws, W.shape[1:], H.shape[1:], X.dtype,
                              X.device, generator)
        W = torch.where((W == 0) & wrow, (avg * zw / 100).abs(), W)
        H = torch.where(H == 0, (avg * zh / 100).abs(), H)
    else:
        W = W * row_valid[:, :, None]
    return W, H


def _frozen_mu(X, W, H, max_iter, tol, update_H):
    """Batched multiplicative updates where each batch row stops on its
    own sklearn rule: a row whose check fires keeps its (W, H); the loop
    ends when every row is done (one host sync every 10 iterations)."""
    err0 = _frob_err(X, W, H)
    scale = torch.where(err0 == 0, 1.0, err0)
    prev = err0
    done = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
    it = 0
    while it < max_iter:
        keep = done[:, None, None]
        for _ in range(min(10, max_iter - it)):
            Wn = _mu_update_w(X, W, H)
            W = torch.where(keep, W, Wn)
            if update_H:
                H = torch.where(keep, H, _mu_update_h(X, Wn, H))
        it += min(10, max_iter - it)
        err = _frob_err(X, W, H)
        done = done | ((prev - err) / scale < tol)
        prev = err
        if bool(done.all()):
            break
    return W, H


def nmf_patch_batched(X, row_valid, curr, n_components, max_iter=100,
                      tol=1e-4, variant="nndsvda", *, draws=None,
                      generator=None):
    """Per-frame NMF patches as one batch (vip_tpu ops/nmf.py:228): fit
    each frame's zero-row-padded library, then transform the frame's own
    row on the fitted components, each frame stopping on its own rule.

    X : (B, L, p) libraries; row_valid : (B, L) 1 for real rows, 0 for
    padding; curr : (B, p) the rows to project. Returns (recon (B, p),
    H_all (B, k, p)).
    """
    k = int(n_components)
    W, H = _nndsvd_init_masked(X, row_valid, k, variant, draws, generator)
    W, H = _frozen_mu(X, W, H, int(max_iter), tol, update_H=True)
    avg = torch.sqrt(curr.mean(dim=1).clamp(min=0) / k)
    W1 = avg[:, None, None].expand(-1, 1, k).to(X.dtype).clone()
    Xc = curr[:, None, :]
    W1, _ = _frozen_mu(Xc, W1, H, int(max_iter), tol, update_H=False)
    return (W1 @ H)[:, 0], H

"""Batched solvers of LOCI's per-frame least-squares problems (port of
``vip_tpu.ops.lsq_solvers``).

For every frame i of a segment LOCI solves ``min_x ||A_iᵀ x − b_i||``,
``A_i`` the frame's similarity- and PA-filtered library; VIP makes one
scipy call a frame. Here every solver reads only the segment Gram matrix
``G = F Fᵀ`` (F the optimisation pixels, one matmul) and the per-frame
boolean library masks, and solves all frames of a segment together on
G's device:

- :func:`masked_lstsq_coeffs`: minimum-norm least squares with scipy's
  ``cond`` cutoff, from the eigendecomposition of each frame's masked
  Gram ``diag(m_i) G diag(m_i)``;
- :func:`batched_nnls_coeffs`: Lawson–Hanson NNLS on the normal
  equations, each frame with its own active set;
- :func:`batched_box_lsq_coeffs`: [0, 1]-bounded least squares by
  projected FISTA with adaptive restart and a KKT stop.

vip_tpu builds the (n, n, n) stack of masked Grams at once (4 GB in
float32 at n = 1000 frames). Here the masked Grams are built and
decomposed in chunks of frames under ``_GRAM_BUDGET_BYTES``, and FISTA
applies them as ``m ⊙ (G (m ⊙ y))`` without forming them. Each returns
the dense (n, n) coefficients, zero outside each frame's mask.
"""

import torch

__all__ = ["masked_lstsq_coeffs", "batched_nnls_coeffs",
           "batched_box_lsq_coeffs", "loci_segment_residuals"]

# The masked Grams of one chunk of frames and the eigh workspace (about
# four (n, n) matrices a frame)
_GRAM_BUDGET_BYTES = 2 << 30
_GRAM_COPIES = 4


def _frame_chunks(G):
    """Slices of frames whose masked Grams fit the budget."""
    n = G.shape[0]
    per_frame = _GRAM_COPIES * n * n * G.element_size()
    step = int(max(1, min(n, _GRAM_BUDGET_BYTES // per_frame)))
    return [slice(s, min(n, s + step)) for s in range(0, n, step)]


def _masked_grams(G, m):
    """diag(m_i) G diag(m_i) for the rows m_i of the float mask ``m``."""
    return m[:, :, None] * G[None] * m[:, None, :]


def masked_lstsq_coeffs(G, masks, tol):
    """Every frame's ``scipy.linalg.lstsq(A_iᵀ, b_i, cond=tol)`` (vip_tpu
    lsq_solvers.py:55): singular values are the square roots of the masked
    Gram's eigenvalues, and those at or below ``tol`` times the largest are
    dropped. The zero rows and columns of the masked Gram give zero
    eigenvalues, which the cutoff drops, so the mask leaves each frame's
    solution intact; the result is zeroed outside the mask."""
    m = masks.to(G.dtype)
    c = m * G.T                     # c[i, j] = masks[i, j] G[j, i] = A_i b_i
    x = torch.empty_like(c)
    for sl in _frame_chunks(G):
        lam, V = torch.linalg.eigh(_masked_grams(G, m[sl]))
        lam = lam.clamp(min=0)
        s = torch.sqrt(lam)
        keep = s > tol * s.amax(dim=1, keepdim=True)
        inv = torch.where(keep, 1.0 / torch.where(lam == 0, 1.0, lam), 0.0)
        proj = torch.einsum("nkj,nk->nj", V, c[sl])          # Vᵀ c
        x[sl] = torch.einsum("nkj,nj->nk", V * inv[:, None, :], proj)
    return x * m


def _solve_on(G, c, P):
    """Per row i: z with G[P_i, P_i] z_P = c_i[P_i] and zeros outside P_i
    (the identity on the complement keeps each system k×k)."""
    Pf = P.to(G.dtype)
    Gp = Pf[:, :, None] * G[None] * Pf[:, None, :] + torch.diag_embed(1 - Pf)
    z = torch.linalg.solve(Gp, (Pf * c)[..., None])[..., 0]
    return torch.where(P, z, 0.0)


def batched_nnls_coeffs(G, masks, max_outer=None):
    """Every frame's ``scipy.optimize.nnls(A_iᵀ, b_i)`` by Lawson–Hanson
    on the normal equations (vip_tpu lsq_solvers.py:146): each frame adds
    its most violating allowed index, solves on its active set, and steps
    back along the segment to the last feasible point while a coefficient
    is not positive; the host loops until no frame is active, and only
    active frames are solved."""
    n = G.shape[0]
    if max_outer is None:
        max_outer = 3 * n
    dtype = G.dtype
    eps = torch.finfo(dtype).eps
    wtol = 10 * eps * max(float(G.abs().max()), 1.0) * n
    allowed = masks.bool()
    c = masks.to(dtype) * G.T
    x = torch.zeros_like(c)
    P = torch.zeros_like(allowed)
    w = c.clone()
    outer = torch.zeros(n, dtype=torch.int64, device=G.device)
    while True:
        cand = allowed & ~P
        active = (cand & (w > wtol)).any(dim=1) & (outer < max_outer)
        ia = torch.nonzero(active).squeeze(1)
        if ia.numel() == 0:
            break
        j = torch.where(cand[ia], w[ia], -torch.inf).argmax(dim=1)
        Pa = P[ia].clone()
        Pa[torch.arange(ia.numel(), device=G.device), j] = True
        xa, ca = x[ia], c[ia]
        za = _solve_on(G, ca, Pa)
        inner = torch.zeros(ia.numel(), dtype=torch.int64, device=G.device)
        while True:
            neg = Pa & (za <= 0)
            ib = torch.nonzero(neg.any(dim=1) & (inner < n + 1)).squeeze(1)
            if ib.numel() == 0:
                break
            xb, zb, nb = xa[ib], za[ib], neg[ib]
            ratio = torch.where(nb, xb / torch.where(xb == zb, 1.0, xb - zb),
                                torch.inf)
            alpha = ratio.amin(dim=1, keepdim=True)
            xb = xb + alpha * (zb - xb)
            Pb = Pa[ib] & (xb > eps)
            xa[ib] = torch.where(Pb, xb, 0.0)
            Pa[ib] = Pb
            za[ib] = _solve_on(G, ca[ib], Pb)
            inner[ib] += 1
        x[ia] = za
        P[ia] = Pa
        w[ia] = ca - za @ G.T
        outer[ia] += 1
    return x


def batched_box_lsq_coeffs(G, masks, lo=0.0, hi=1.0, block=500,
                           max_blocks=400, kkt_rtol=1e-12):
    """Every frame's ``scipy.optimize.lsq_linear(A_iᵀ, b_i, bounds=(0,
    1))`` by projected FISTA with adaptive restart (vip_tpu
    lsq_solvers.py:161): steps of 1/L_i (L_i the largest eigenvalue of
    the frame's masked Gram) in blocks of ``block``, until the largest
    KKT violation of the box QP over all frames falls below ``kkt_rtol``
    times max |c| or ``max_blocks`` blocks have run (one host sync a
    block)."""
    m = masks.to(G.dtype)
    c = m * G.T
    tiny = torch.finfo(G.dtype).tiny
    L = torch.empty(G.shape[0], dtype=G.dtype, device=G.device)
    for sl in _frame_chunks(G):
        L[sl] = torch.linalg.eigvalsh(_masked_grams(G, m[sl]))[:, -1]
    step = (1.0 / L.clamp(min=tiny))[:, None]
    cscale = max(float(c.abs().max()), tiny)

    def gram_apply(y):
        # rows of diag(m_i) G diag(m_i) y_i, without forming the stack
        return m * ((m * y) @ G.T)

    def kkt_residual(x):
        g = gram_apply(x) - c
        viol = torch.where(x <= lo + 1e-14, (-g).clamp(min=0),
                           torch.where(x >= hi - 1e-14, g.clamp(min=0),
                                       g.abs()))
        return float((viol * m).max())

    x = torch.zeros_like(c)
    y = x.clone()
    t = torch.ones(c.shape[0], dtype=G.dtype, device=G.device)
    blocks = 0
    while blocks < max_blocks and kkt_residual(x) > kkt_rtol * cscale:
        for _ in range(block):
            x_new = (y - step * (gram_apply(y) - c)).clamp(lo, hi) * m
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            mom = (t - 1.0) / t_new
            # adaptive restart (O'Donoghue & Candès), per frame
            restart = ((y - x_new) * (x_new - x)).sum(dim=1) > 0
            y = torch.where(restart[:, None], x_new,
                            x_new + mom[:, None] * (x_new - x))
            t = torch.where(restart, 1.0, t_new)
            x = x_new
        blocks += 1
    return x


def loci_segment_residuals(values, values_opt, masks, tol, solver="lstsq"):
    """One LOCI segment (vip_tpu lsq_solvers.py:207): the Gram of the
    optimisation pixels, every frame's coefficients by ``solver``
    ('lstsq', 'nnls' or 'lsq'), and the residuals ``values − coeffs @
    values`` (n, p)."""
    G = values_opt @ values_opt.T
    if solver == "lstsq":
        coeffs = masked_lstsq_coeffs(G, masks, tol)
    elif solver == "nnls":
        coeffs = batched_nnls_coeffs(G, masks)
    elif solver == "lsq":
        coeffs = batched_box_lsq_coeffs(G, masks)
    else:
        raise ValueError("`solver` not recognized")
    return values - coeffs @ values

"""Linear-algebra cores of PSF subtraction (port of ``vip_tpu.ops.linalg``).

- ``svd_top``: top-k right singular vectors by 'lapack' (QR + small SVD
  for tall matrices), 'eigen' (Gram ``eigh`` trick) or 'randsvd' (Halko).
- ``matrix_scaling_jax``: sklearn.preprocessing.scale semantics.
- ``project_subtract``: SVD → project → reconstruct → residual.
- ``svd``: every SVD of the port goes through it. A CUDA float32 batch of
  matrices whose sides are both at most 64 takes the batched one-sided
  Jacobi kernel K5 (``svd_jacobi``, ``csrc/svd_jacobi.cu``) in one launch;
  every other CUDA tensor takes cuSOLVER's QR-based ``gesvd``, a CPU
  tensor ``torch.linalg.svd``.
- ``svd_jacobi`` / ``svd_jacobi_plain``: K5 and its plain PyTorch version
  (the same rotations in the same order, the same stopping rule).
- ``svd_subspace``: the top-ncomp triplets of large square R factors by a
  float64 subspace iteration on R Rᵀ (``_subspace_topk``, which the
  annular PCA's library Grams share), gesvd where it does not converge;
  ``svd_top``'s 'lapack' branch takes it where ``subspace_route`` says so
  and then applies Q to the ncomp columns alone.

vip_tpu left these to XLA and has no Pallas code here; on the card they
stay ``torch.matmul`` and ``torch.linalg`` (cuBLAS/cuSOLVER), and K5
replaces no TPU kernel. Every ``torch.linalg`` factorization of the
port's full-frame PCA runs here, each in a span (``factorization.qr``,
``.svd``, ``.eigh``) whose count is the number of matrices it factors
(``config.timing``); K5's launches are spans ``factorization.svd_jacobi``
inside ``factorization.svd``, counted the same way, and the subspace
route's are spans ``factorization.svd_subspace`` there, counting the
matrices it returned converged.
"""

import math

import torch

from ..config.timing import annotate_trace, traced

__all__ = ["svd_top", "matrix_scaling_jax", "project_subtract",
           "randomized_svd", "svd", "svd_jacobi", "svd_jacobi_plain",
           "jacobi_route", "svd_subspace", "subspace_route"]

#: Number of K5 kernel launches since the last reset (set it to 0 to reset).
jacobi_launches = 0

# K5's bounds, as csrc/svd_jacobi.cu states them: the largest side a block
# holds in shared memory, the sweep cap (LAPACK's sgesvj/dgesvj stop at 30
# sweeps too; a random 64-column matrix converges in about 10), and the
# stopping rule's tolerance, float32's epsilon: a pair of columns is
# rotated while |a_i . a_j| > JACOBI_TOL * |a_i| |a_j|
JACOBI_MAX_SIDE = 64
JACOBI_MAX_SWEEPS = 30
JACOBI_TOL = torch.finfo(torch.float32).eps


def _matrices(A, *args, **kwargs):
    """The count of a factorization's span: the matrices of its [..., m, n]
    batch."""
    return A.shape[:-2].numel()


def jacobi_route(A, full_matrices=False):
    """Whether :func:`svd` takes K5 for ``A``: a CUDA float32 tensor of
    [..., m, n] matrices with 1 <= m, n <= 64, and the thin factors
    (``full_matrices=False``). Decided from the tensor alone."""
    return (A.device.type == "cuda" and A.dtype == torch.float32
            and not full_matrices and A.ndim >= 2
            and 1 <= min(A.shape[-2:])
            and max(A.shape[-2:]) <= JACOBI_MAX_SIDE)


@traced("factorization.svd", _matrices)
def svd(A, full_matrices=False):
    """``torch.linalg.svd(A, full_matrices)``. On a CUDA tensor: K5
    (:func:`svd_jacobi`) where :func:`jacobi_route` says so, else the
    QR-based cuSOLVER routine ``gesvd``, one call a matrix of the batch.

    PyTorch's default CUDA routine is the Jacobi ``gesvdj``. On the golden
    NACO replica in float32 its top singular vector is as close to the
    float64 one as gesvd's in angle (4.6e-7 against 2.3e-7), but its error
    is not spread like a rounding error: the full-frame PCA frame came out
    1.419e-01 from VIP's golden against 1.425e-03 with gesvd, and the
    annular one 3.465e-02 against 2.064e-03, where the same float32 code
    on a CPU gives 1.287e-03 and 1.487e-03 (ROADMAP.md Queue 3, F2; NVIDIA
    H100 80GB HBM3 at 700 W, ``chip_smoke.py --f2``). K5 is a Jacobi SVD
    too, but with cuSOLVER's ``gesvdj`` it shares only the name: its
    stopping rule holds every pair of columns orthogonal to float32's
    epsilon relative to their norms, in float64 arithmetic, where gesvdj
    stops on the off-diagonal mass of the whole matrix.

    Errors differ by route. ``torch.linalg.svd`` (the CPU, and gesvd on
    the card) raises where the routine does not converge or the input is
    not finite, as VIP's numpy SVD does. K5 raises on neither, since its
    ``info`` stays on the card and nothing waits for it: a matrix that
    meets the sweep cap returns its last sweep's factors, and a non-finite
    input gives non-finite factors (:func:`svd_jacobi` with ``with_info``
    reports both).
    """
    if jacobi_route(A, full_matrices):
        return svd_jacobi(A)
    return _gesvd(A, full_matrices)


def _gesvd(A, full_matrices=False):
    """cuSOLVER's ``gesvd`` on a CUDA tensor, ``torch.linalg.svd`` on the
    CPU."""
    if A.is_cuda:
        return torch.linalg.svd(A, full_matrices=full_matrices,
                                driver="gesvd")
    return torch.linalg.svd(A, full_matrices=full_matrices)


def _round_robin(K):
    """The round-robin ordering of K (even) columns: K - 1 steps of K / 2
    disjoint pairs (i, j), every pair once a sweep; column 0 stays in
    place and the others turn one place a step (csrc/svd_jacobi.cu)."""
    return [[(0 if p == 0 else (p - 1 + r) % (K - 1) + 1,
              (K - 2 - p + r) % (K - 1) + 1) for p in range(K // 2)]
            for r in range(K - 1)]


def _complete(Q, null):
    """Fill the columns of Q (L, k) marked ``null`` (zero singular
    values), in index order, with unit vectors orthogonal to every other
    column and to those filled before: the unit vector e_t of the row t
    where the columns so far have the least norm (the first such row),
    less its projections on them, twice (Gram-Schmidt, column by
    column), normalized."""
    for c in torch.nonzero(null).flatten().tolist():
        basis = [q for q in range(Q.shape[1]) if not null[q] or q < c]
        t = int(torch.argmin((Q[:, basis] ** 2).sum(1)))
        v = torch.zeros_like(Q[:, c])
        v[t] = 1.0
        for _ in range(2):
            for q in basis:
                v = v - (Q[:, q] @ v) * Q[:, q]
        Q[:, c] = v / torch.sqrt((v * v).sum())


def svd_jacobi_plain(A, with_info=False):
    """The plain PyTorch version of K5: the thin SVD of each [m, n] matrix
    of ``A`` (any sides, float32 or float64) by one-sided (Hestenes)
    Jacobi in float64, as ``torch.linalg.svd(A, full_matrices=False)``
    lays it out, in ``A``'s dtype.

    Each matrix is held with its columns along the short side: A itself
    when m >= n, Aᵀ otherwise (k = min(m, n) columns of L = max(m, n)).
    A sweep visits every pair of columns once, in :func:`_round_robin`'s
    order (a dummy column pads an odd k), and rotates a pair
    (Rutishauser's angle, which makes it orthogonal) where |a_i . a_j| >
    JACOBI_TOL |a_i| |a_j|; the same rotations accumulate from the
    identity into the other factor. Sweeps stop after the first that
    rotates no pair, or after JACOBI_MAX_SWEEPS. The singular values are
    the columns' norms, in descending order (ties by column); the
    columns over their norms are the singular vectors on the long side,
    those of zero norm completed to an orthonormal set
    (:func:`_complete`).

    With ``with_info`` also returns ``info``, int32 of the batch's shape:
    the sweeps a matrix took, or -1 where no sweep was quiet within the
    cap or a singular value is not finite.
    """
    m, n = A.shape[-2:]
    k = min(m, n)
    X = A.reshape(-1, m, n).to(torch.float64)
    W = (X if m >= n else X.mT).clone()             # (B, L, k)
    B = W.shape[0]
    V = torch.eye(k, dtype=torch.float64, device=A.device).repeat(B, 1, 1)
    sweeps = torch.zeros(B, dtype=torch.int32, device=A.device)
    quiet = torch.zeros(B, dtype=torch.bool, device=A.device)
    steps = [[(i, j) for i, j in pairs if i < k and j < k]
             for pairs in _round_robin(k + k % 2)]
    steps = [(torch.tensor([i for i, _ in pairs], device=A.device),
              torch.tensor([j for _, j in pairs], device=A.device))
             for pairs in steps if pairs]
    for sweep in range(1, JACOBI_MAX_SWEEPS + 1):
        rotated = torch.zeros_like(quiet)
        for i, j in steps:
            ai, aj = W[..., i], W[..., j]
            alpha, beta = (ai * ai).sum(-2), (aj * aj).sum(-2)
            gamma = (ai * aj).sum(-2)
            rot = gamma.abs() > JACOBI_TOL * alpha.sqrt() * beta.sqrt()
            zeta = (beta - alpha) / (2 * torch.where(rot, gamma, 1.0))
            one = torch.ones_like(zeta)
            t = torch.copysign(one, zeta) / (zeta.abs()
                                             + torch.hypot(one, zeta))
            c = 1 / torch.sqrt(1 + t * t)
            s, c, r = (c * t)[:, None], c[:, None], rot[:, None]
            for M in (W, V):
                xi, xj = M[..., i], M[..., j]
                M[..., i] = torch.where(r, c * xi - s * xj, xi)
                M[..., j] = torch.where(r, s * xi + c * xj, xj)
            rotated |= rot.any(-1)
        sweeps = torch.where(quiet, sweeps, sweep)
        quiet |= ~rotated
        if bool(quiet.all()):
            break
    sig = torch.sqrt((W * W).sum(-2))               # (B, k)
    null = sig == 0
    W = W / torch.where(null, 1.0, sig)[:, None]
    for b in torch.nonzero(null.any(-1)).flatten().tolist():
        _complete(W[b], null[b])
    # a NaN norm ranks last, as in the kernel
    key = torch.where(torch.isnan(sig), -1.0, sig)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    sig = sig.gather(-1, order)
    cols = order[:, None].expand(-1, W.shape[1], -1)
    Wo = W.gather(-1, cols)
    Vo = V.gather(-1, order[:, None].expand(-1, k, -1))
    U, Vh = (Wo, Vo.mT) if m >= n else (Vo, Wo.mT)
    batch = A.shape[:-2]
    out = torch.return_types.linalg_svd((
        U.to(A.dtype).reshape(*batch, m, k),
        sig.to(A.dtype).reshape(*batch, k),
        Vh.to(A.dtype).reshape(*batch, k, n)))
    if not with_info:
        return out
    info = torch.where(quiet & torch.isfinite(sig).all(-1), sweeps, -1)
    return (*out, info.to(torch.int32).reshape(batch))


@traced("factorization.svd_jacobi", _matrices)
def svd_jacobi(A, with_info=False):
    """K5: the thin SVD of a batch of small matrices in one launch of
    ``csrc/svd_jacobi.cu``, as ``torch.linalg.svd(A, full_matrices=False)``
    lays it out; the algorithm is :func:`svd_jacobi_plain`'s. A CPU tensor
    takes the plain version. A CUDA tensor must pass :func:`jacobi_route`
    (float32, 1 <= m, n <= 64), or this raises: nothing falls back. The
    kernel runs on the current stream and nothing waits for it, so it
    raises neither on a matrix that meets the sweep cap nor on a
    non-finite one. With ``with_info``, also ``info`` as
    :func:`svd_jacobi_plain` gives it (-1 for both)."""
    global jacobi_launches
    if A.device.type == "cpu":
        return svd_jacobi_plain(A, with_info)
    if not jacobi_route(A):
        raise ValueError(f"svd_jacobi: the kernel takes float32 CUDA "
                         f"[..., m, n] with 1 <= m, n <= {JACOBI_MAX_SIDE}, "
                         f"got {A.dtype} {tuple(A.shape)} on {A.device}")
    from .._build import check, load

    m, n = A.shape[-2:]
    k, batch = min(m, n), A.shape[:-2]
    X = A.reshape(-1, m, n).contiguous()
    B = X.shape[0]
    U = torch.empty((B, m, k), dtype=A.dtype, device=A.device)
    S = torch.empty((B, k), dtype=A.dtype, device=A.device)
    Vh = torch.empty((B, k, n), dtype=A.dtype, device=A.device)
    info = torch.empty(B, dtype=torch.int32, device=A.device)
    if B:
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = load().vip_svd_jacobi(X.data_ptr(), U.data_ptr(),
                                       S.data_ptr(), Vh.data_ptr(),
                                       info.data_ptr(), B, m, n, stream)
        check(rc, "svd_jacobi")
        jacobi_launches += 1
    out = torch.return_types.linalg_svd((U.reshape(*batch, m, k),
                                         S.reshape(*batch, k),
                                         Vh.reshape(*batch, k, n)))
    if not with_info:
        return out
    return (*out, info.reshape(batch))


def _default_sketch(L, m, dtype, device):
    """The subspace iteration's start when none is given: a Gaussian (L, m)
    draw from a ``torch.Generator`` seeded with 7 (vip_tpu draws from
    ``jax.random.PRNGKey(7)``; the two generators give other numbers)."""
    gen = torch.Generator(device=device).manual_seed(7)
    return torch.randn((L, m), generator=gen, dtype=dtype, device=device)


# The subspace iteration stops once each of the top ``ncomp`` Ritz pairs
# (θ, u) of every matrix has ‖A u − θ u‖ ≤ SUBSPACE_TOL·θ₁, or after
# SUBSPACE_MAX_STEPS steps; the first test comes after _SUBSPACE_CHECK.
SUBSPACE_TOL = 1e-7
SUBSPACE_MAX_STEPS = 500
_SUBSPACE_CHECK = 5


def _orth(B, passes=3):
    """An orthonormal basis of the columns of a batch of tall (..., L, m)
    blocks by Cholesky QR: with ``passes`` 3, shifted CholeskyQR3 (Fukaya
    et al. 2020, SIAM J. Sci. Comput. 42, A477), orthonormal to float64's
    rounding for blocks of condition up to ~1e15; with 1, the first pass
    alone, whose columns span the block's dominant directions but are
    orthonormal only to ~1e-16 of the squared condition. Each pass is a
    handful of batched calls whatever m (Householder's Q takes a loop of
    m reflector updates): the (m, m) Gram, its Cholesky factor C, the
    inverse of C and one product. The first pass shifts the Gram by ~1e-11
    of its trace, which keeps C defined on rank-deficient blocks; the
    others by ~1e-15. Columns that are exactly zero stay zero."""
    m = B.shape[-1]
    eye = torch.eye(m, dtype=B.dtype, device=B.device)
    tiny = torch.finfo(B.dtype).tiny
    Q = B
    for p in range(passes):
        T = Q.transpose(-1, -2) @ Q
        shift = (1e-11 if p == 0 else 1e-15) \
            * T.diagonal(dim1=-2, dim2=-1).sum(-1, keepdim=True) + tiny
        T.diagonal(dim1=-2, dim2=-1).add_(shift)
        C = torch.linalg.cholesky_ex(T)[0]                  # T = C Cᵀ
        Q = Q @ torch.linalg.solve_triangular(C, eye, upper=False) \
            .transpose(-1, -2)
    return Q


def _rayleigh_ritz(Q, AQ, ncomp):
    """The top ``ncomp`` Ritz pairs of A on the orthonormal block Q, given
    AQ = A @ Q: (θ (..., ncomp) descending, U = Q W, A U = AQ W)."""
    T = Q.transpose(-1, -2) @ AQ
    e, W = torch.linalg.eigh(0.5 * (T + T.transpose(-1, -2)))
    W = W.flip(-1)[..., :ncomp]
    return e.flip(-1)[..., :ncomp], Q @ W, AQ @ W


def _next_test(step, resid, last, tol):
    """The step of the next residual test: from the rate at which the
    residual fell since the ``last`` test (step, residual), the step where
    it should reach ``tol``, 2 to 40 steps on; _SUBSPACE_CHECK steps on
    where there is no rate yet."""
    if last is None or not 0 < resid < last[1]:
        return step + _SUBSPACE_CHECK
    rate = math.log(resid / last[1]) / (step - last[0])
    ahead = math.ceil(math.log(tol / resid) / rate)
    return step + min(max(ahead, 2), 40)


def _beyond_cap(step, resid, last, tol, max_steps):
    """Which matrices of a batch, their residuals ``resid`` (B,) at
    ``step``, falling each at the rate it showed since the ``last`` test
    (step, residuals (B,)), would still be above ``tol`` at ``max_steps``;
    every one whose residual did not fall, or is not finite; none where
    there is no last test yet."""
    if last is None:
        return torch.zeros_like(resid, dtype=torch.bool)
    fell = (resid > 0) & (resid < last[1])
    rate = torch.log(resid / last[1]) / (step - last[0])
    return ~fell | (step + torch.log(tol / resid) / rate > max_steps)


def _subspace_topk(Gm, ncomp, oversample=8, sketch=None, pairs_tol=None,
                   max_steps=None):
    """Top-``ncomp`` eigenpairs of a batch of symmetric PSD Grams
    (..., L, L) by blocked subspace iteration, run to convergence: a
    block of m = min(L, ncomp + oversample) columns, multiplied by the
    Gram every step and orthonormalized by :func:`_orth` (one pass, three
    before a test), and at each test a Rayleigh-Ritz step. A matrix whose
    top ``ncomp`` pairs all have residuals under the tolerance (module
    constants) leaves the batch with them; :func:`_next_test` places the
    tests from the rate at which the worst residual left falls. It works
    in float64 whatever ``Gm``'s dtype: the residuals it stops on lie far
    below float32's resolution. vip_tpu (annular.py:89) runs a fixed 30
    steps in the input's precision, which leaves the top components
    unconverged where the spectrum is flat past ncomp (the outer annuli
    at ncomp ~10).

    ``sketch`` is the (L, m) starting block, shared by every matrix of
    the batch; None draws it with :func:`_default_sketch`. Each test reads
    a few numbers back to the host. Returns (e_top (..., ncomp), U_top
    (..., L, ncomp)), descending, in ``Gm``'s dtype, and (...,) whether
    each matrix met the rule (False where it stopped at the cap).

    With ``pairs_tol`` τ the rule holds each pair to its own scale: a
    matrix leaves once every returned pair has ‖A u_i − θ_i u_i‖ ≤
    τ·√(θ₁θ_i) (a pair with θ_i ≤ 0 never passes). The others stop, with
    their last Ritz pairs, at the step cap, or from the second test on as
    soon as their own residual would not meet it by the cap at the rate it
    fell since the test before (:func:`_beyond_cap`): a matrix whose
    spectrum is flat about the ncomp-th value then costs a few steps, not
    the cap, and leaves the others of its batch running. ``max_steps`` is
    that cap, SUBSPACE_MAX_STEPS where None.
    """
    L = Gm.shape[-1]
    m = min(L, ncomp + oversample)
    if sketch is None:
        sketch = _default_sketch(L, m, torch.float64, Gm.device)
    elif tuple(sketch.shape) != (L, m):
        raise ValueError(f"sketch must have shape {(L, m)}, got "
                         f"{tuple(sketch.shape)}")
    lead = Gm.shape[:-2]
    G64 = Gm.reshape(-1, L, L).to(torch.float64)
    # normalize to keep the spectral radius near 1
    scale = torch.clamp(G64.abs().amax(dim=(-2, -1)), min=1e-300)
    A = G64 / scale[:, None, None]
    k = min(ncomp, m)
    e_out = G64.new_zeros((A.shape[0], k))
    U_out = G64.new_zeros((A.shape[0], L, k))
    met_out = torch.zeros(A.shape[0], dtype=torch.bool, device=Gm.device)
    live = torch.arange(A.shape[0], device=Gm.device)
    Q = _orth(A @ sketch.to(Gm.device, torch.float64))
    tol = SUBSPACE_TOL if pairs_tol is None else pairs_tol
    if max_steps is None:
        max_steps = SUBSPACE_MAX_STEPS
    step, test, last, last_r = 0, _SUBSPACE_CHECK, None, None
    while live.numel():
        AQ = A @ Q
        step += 1
        if step >= min(test, max_steps):
            e, U, AU = _rayleigh_ritz(Q, AQ, ncomp)
            top = torch.clamp(e[:, :1], min=1e-300)
            r = (AU - U * e[:, None, :]).norm(dim=-2)
            resid = (r / (top if pairs_tol is None
                          else torch.sqrt(top * e))).amax(-1)
            met = resid <= tol
            done = met if step < max_steps else torch.ones_like(met)
            if pairs_tol is not None:
                done = done | _beyond_cap(
                    step, resid, None if last is None else (last[0], last_r),
                    tol, max_steps)
            left = torch.where(done, 0.0, resid)
            n_done, worst = torch.stack([done.sum().to(left.dtype),
                                         left.amax()]).tolist()
            if n_done:
                fin = done.nonzero()[:, 0]
                e_out[live[fin]] = e[fin]
                U_out[live[fin]] = U[fin]
                met_out[live[fin]] = met[fin]
                if n_done == live.numel():
                    break
                keep = (~done).nonzero()[:, 0]
                live, A, AQ = live[keep], A[keep], AQ[keep]
                resid = resid[keep]
            test, last = _next_test(step, worst, last, tol), (step, worst)
            last_r = resid
        Q = _orth(AQ, passes=3 if step + 1 >= test else 1)
    e_out = e_out * scale[:, None]
    return (e_out.reshape(*lead, k).to(Gm.dtype),
            U_out.reshape(*lead, L, k).to(Gm.dtype), met_out.reshape(lead))


#: Matrices that :func:`svd_subspace` returned converged since the last
#: reset (set it to 0 to reset).
subspace_matrices = 0

# svd_top's top-ncomp route for large R factors (svd_subspace). On an
# H100 it took 2.4-16x less time than the gesvd route at 512 to 3900 rows
# on model ADI and IFS sequences and NEGFC walker batches (5 steps), about
# as long at side 100; a matrix whose spectrum is flat about the ncomp-th
# value (a noise floor: white noise at any side) stops after 10 to 45
# steps of ~0.3-0.5 ms and takes gesvd alone, up to ~30 ms more than
# gesvd at sides 256-512: hence the least side and the step cap.
# Its block of at least SUBSPACE_SVD_BLOCK columns costs ~2 GFLOP of
# float64 a step at side 3900. τ of its per-pair stopping rule is
# float32's epsilon: the annular rule, ‖A u − θ u‖ ≤ 1e-7·θ₁, bounds a
# vector's angle by ~1e-7·θ₁ over its gap, which for the squared spectrum
# of R Rᵀ is up to σ₁/σ_i times coarser than float32 gesvd's answer on R;
# ‖G u_i − θ_i u_i‖ ≤ τ·σ₁σ_i keeps every returned vector at least as
# close to float64 as that answer.
SUBSPACE_SVD_MIN_SIDE = 512
SUBSPACE_SVD_BLOCK = 64
SUBSPACE_SVD_TOL = torch.finfo(torch.float32).eps
SUBSPACE_SVD_MAX_STEPS = 100


def _subspace_block(ncomp):
    """The columns of :func:`svd_subspace`'s block for ``ncomp`` pairs."""
    return max(SUBSPACE_SVD_BLOCK, ncomp + 8)


def subspace_route(A, ncomp):
    """Whether :func:`svd_top`'s 'lapack' branch takes its top-ncomp route
    for ``A`` [..., n, p] (p > 4n): a CUDA float32 tensor with n >=
    SUBSPACE_SVD_MIN_SIDE rows, at least four times the route's block.
    Decided from the tensor and ``ncomp`` alone."""
    n = A.shape[-2] if A.ndim >= 2 else 0
    return (A.device.type == "cuda" and A.dtype == torch.float32
            and n >= SUBSPACE_SVD_MIN_SIDE
            and 4 * _subspace_block(ncomp) <= n)


@traced("factorization.svd", _matrices)
def svd_subspace(R, ncomp):
    """The top ``ncomp`` singular triplets of each square matrix of a
    [..., n, n] batch, as ``torch.linalg.svd(R, full_matrices=False)``
    lays them out cut to k = min(ncomp, n): (U (..., n, k), S (..., k),
    Vh (..., k, n)), in R's dtype.

    G = R Rᵀ is formed in float64 and its top k eigenpairs (θ, u) found
    by :func:`_subspace_topk` with a block of :func:`_subspace_block`
    columns and the per-pair rule at ``SUBSPACE_SVD_TOL``; then S = √θ,
    U = u signed so that its entry of largest magnitude is positive (one
    fixed rule: a run repeats bit for bit), and Vh = Uᵀ R / S. A matrix
    that is not finite, or whose residuals do not meet the rule within
    ``SUBSPACE_SVD_MAX_STEPS``, takes gesvd instead (``torch.linalg.svd``
    on the CPU), which raises where it raises in :func:`svd`. The
    converged matrices are counted in the span
    ``factorization.svd_subspace`` and in ``subspace_matrices``.
    """
    global subspace_matrices
    n = R.shape[-1]
    k = min(ncomp, n)
    lead = R.shape[:-2]
    X = R.reshape(-1, n, n)
    U = X.new_empty((X.shape[0], n, k))
    S = X.new_empty((X.shape[0], k))
    Vh = X.new_empty((X.shape[0], k, n))
    ok = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
    finite = torch.isfinite(X).flatten(1).all(1).nonzero()[:, 0]
    with annotate_trace("factorization.svd_subspace") as span:
        if finite.numel():
            X64 = X[finite].to(torch.float64)
            e, W, met = _subspace_topk(
                X64 @ X64.mT, k, oversample=_subspace_block(ncomp) - k,
                pairs_tol=SUBSPACE_SVD_TOL,
                max_steps=SUBSPACE_SVD_MAX_STEPS)
            peak = W.abs().argmax(-2, keepdim=True)
            W = W * torch.where(W.gather(-2, peak) < 0, -1.0, 1.0)
            s = torch.sqrt(e)
            U[finite] = W.to(X.dtype)
            S[finite] = s.to(X.dtype)
            Vh[finite] = (W.mT @ X64 / s[..., None]).to(X.dtype)
            ok[finite] = met
        n_ok = int(ok.sum())
        subspace_matrices += n_ok
        if span is not None:
            span.set_count(n_ok)
    if n_ok < X.shape[0]:
        rest = (~ok).nonzero()[:, 0]
        Ur, Sr, Vr = _gesvd(X[rest])
        U[rest], S[rest], Vh[rest] = Ur[..., :k], Sr[..., :k], Vr[..., :k, :]
    return torch.return_types.linalg_svd((U.reshape(*lead, n, k),
                                          S.reshape(*lead, k),
                                          Vh.reshape(*lead, k, n)))


@traced("factorization.qr", _matrices)
def _geqrf(A):
    return torch.geqrf(A)


def _qr_top(matrix, ncomp):
    """The top ``ncomp`` triplets of the thin SVD of ``matrix``ᵀ
    (..., p, n), p > 4n, from its R factor: Householder QR (geqrf),
    R's triplets by :func:`svd_subspace`, and Q applied to their ncomp
    columns alone (ormqr), where the full route forms Q (orgqr) and
    multiplies it by all n columns of R's U."""
    n = matrix.shape[-2]
    a, tau = _geqrf(matrix.mT)
    Ur, S, Vh = svd_subspace(a[..., :n, :].triu(), ncomp)
    C = Ur.new_zeros((*Ur.shape[:-2], a.shape[-2], Ur.shape[-1]))
    C[..., :n, :] = Ur
    return torch.ormqr(a, tau, C), S, Vh


@traced("factorization.qr", _matrices)
def _qr(A):
    return torch.linalg.qr(A)


@traced("factorization.eigh", _matrices)
def _eigh(A):
    return torch.linalg.eigh(A)


def matrix_scaling_jax(matrix, scaling):
    """Pixel-wise scaling of a [n, p] matrix, or of each matrix of a
    [..., n, p] batch (vip_tpu linalg.py:28). The standard deviation is
    the population one (``correction=0``), as numpy's and jnp's default
    ``ddof=0``."""
    if scaling is None:
        return matrix
    if scaling == "temp-mean":
        return matrix - matrix.mean(dim=-2, keepdim=True)
    elif scaling == "spat-mean":
        return matrix - matrix.mean(dim=-1, keepdim=True)
    elif scaling == "temp-standard":
        centered = matrix - matrix.mean(dim=-2, keepdim=True)
        std = matrix.std(dim=-2, keepdim=True, correction=0)
        scaled = centered / torch.where(std == 0, 1.0, std)
        return scaled - scaled.mean(dim=-2, keepdim=True)
    elif scaling == "spat-standard":
        centered = matrix - matrix.mean(dim=-1, keepdim=True)
        std = matrix.std(dim=-1, keepdim=True, correction=0)
        scaled = centered / torch.where(std == 0, 1.0, std)
        return scaled - scaled.mean(dim=-1, keepdim=True)
    raise ValueError("Scaling mode not recognized")


def randomized_svd(matrix, ncomp, omega=None, n_oversamples=10, n_iter=2,
                   *, generator=None):
    """Halko et al. randomized SVD (vip_tpu linalg.py:54). Returns
    (U, S, Vh) with ``ncomp`` components; power iterations are
    QR-stabilized.

    ``omega`` is the Gaussian sketch, of shape (min-side, k) with
    ``k = min(ncomp + n_oversamples, n, p)``; it takes the slot of
    vip_tpu's ``key``. When it is None it is drawn with the keyword-only
    ``generator`` on the matrix's device.
    """
    n, p = matrix.shape
    k = min(ncomp + n_oversamples, min(n, p))
    transpose = n < p  # sklearn transpose='auto' heuristic for wide inputs
    A = matrix.T if transpose else matrix
    if omega is None:
        omega = torch.randn((A.shape[1], k), generator=generator,
                            dtype=matrix.dtype, device=matrix.device)
    elif tuple(omega.shape) != (A.shape[1], k):
        raise ValueError(f"omega must have shape {(A.shape[1], k)}, got "
                         f"{tuple(omega.shape)}")
    Q = A @ omega.to(matrix.device, matrix.dtype)
    for _ in range(n_iter):
        Q, _ = _qr(A.T @ Q)
        Q, _ = _qr(A @ Q)
    Q, _ = _qr(Q)
    B = Q.T @ A
    Ub, S, Vh = svd(B)
    U = Q @ Ub
    U, S, Vh = U[:, :ncomp], S[:ncomp], Vh[:ncomp]
    if transpose:
        return Vh.T, S, U.T
    return U, S, Vh


@traced("factorization.svd_top")
def svd_top(matrix, ncomp, method="lapack", omega=None, full_output=False,
            *, generator=None):
    """Top-``ncomp`` principal components (right singular vectors) of a
    [n, p] matrix, shape (ncomp, p) (vip_tpu linalg.py:80), or of each
    matrix of a [..., n, p] batch, shape (..., ncomp, p): 'lapack' and
    'eigen' factor the whole batch in one call, 'randsvd' one matrix
    after another, each with its own draw.

    method='lapack'  → SVD of matrixᵀ, through a tall-skinny QR when
                       p > 4n so the SVD only sees the n×n factor; where
                       :func:`subspace_route` says so, only R's top
                       ``ncomp`` triplets (:func:`svd_subspace`) and Q
                       on their columns (:func:`_qr_top`).
    method='eigen'   → eigh of the n×n Gram matrix.
    method='randsvd' → randomized SVD (``omega``/``generator``, see
                       :func:`randomized_svd`).

    The positional order is vip_tpu's, ``omega`` in the slot of its
    ``key``; ``generator`` is keyword-only.

    With ``full_output`` returns (U, S, V): U (n, ncomp), S (ncomp,),
    V (ncomp, p), in vip_tpu's orientation.
    """
    n = matrix.shape[-2]
    if method == "lapack":
        if matrix.shape[-1] > 4 * n and subspace_route(matrix, ncomp):
            U2, S2, V2 = _qr_top(matrix, ncomp)
        elif matrix.shape[-1] > 4 * n:
            Q, R = _qr(matrix.mT)
            Ur, S2, V2 = svd(R)
            U2 = Q @ Ur
        else:
            U2, S2, V2 = svd(matrix.mT)
        V = U2[..., :ncomp].mT
        if full_output:
            return V2[..., :ncomp, :].mT, S2[..., :ncomp], V
        return V
    elif method == "eigen":
        C = matrix @ matrix.mT
        e, EV = _eigh(C)
        S = torch.sqrt(torch.abs(e)).flip(-1)
        V = ((EV.mT @ matrix).flip(-2) / S[..., :, None])[..., :ncomp, :]
        if full_output:
            U = (EV / torch.sqrt(torch.abs(e))[..., None, :])[..., :ncomp, :]
            return U, S[..., :ncomp], V
        return V
    elif method in ("randsvd", "arpack") and matrix.ndim > 2:
        outs = [svd_top(m, ncomp, method, omega, full_output,
                        generator=generator) for m in matrix]
        if full_output:
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)
    elif method in ("randsvd", "arpack"):
        if omega is None and generator is None:
            # deterministic by default, as vip_tpu's PRNGKey(0)
            generator = torch.Generator(matrix.device).manual_seed(0)
        U, S, Vh = randomized_svd(matrix, ncomp, omega=omega,
                                  generator=generator)
        if full_output:
            return U, S, Vh
        return Vh
    raise ValueError(f"SVD method {method!r} not recognized")


@traced("factorization.project_subtract")
def project_subtract(matrix, matrix_ref, ncomp, method="lapack", omega=None,
                     matrix_sig=None, full_output=False, *, generator=None):
    """PCA project-and-subtract on prepared [n, p] matrices (vip_tpu
    linalg.py:135): the PCs come from ``matrix_ref`` (or from the
    signal-subtracted science matrix), the projection applies to the
    signal-subtracted science matrix, and the residual subtracts the
    reconstruction from the original matrix."""
    matrix_emp = matrix if matrix_sig is None else matrix - matrix_sig
    lib = matrix_emp if matrix_ref is None else matrix_ref
    V = svd_top(lib, ncomp, method=method, omega=omega, generator=generator)
    reconstructed = (V @ matrix_emp.T).T @ V
    residuals = matrix - reconstructed
    if full_output:
        return residuals, reconstructed, V
    return residuals

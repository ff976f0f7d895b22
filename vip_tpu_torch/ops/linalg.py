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

vip_tpu left these to XLA and has no Pallas code here; on the card they
stay ``torch.matmul`` and ``torch.linalg`` (cuBLAS/cuSOLVER), and K5
replaces no TPU kernel. Every ``torch.linalg`` factorization of the
port's full-frame PCA runs here, each in a span (``factorization.qr``,
``.svd``, ``.eigh``) whose count is the number of matrices it factors
(``config.timing``); K5's launches are spans ``factorization.svd_jacobi``
inside ``factorization.svd``, counted the same way.
"""

import torch

from ..config.timing import traced

__all__ = ["svd_top", "matrix_scaling_jax", "project_subtract",
           "randomized_svd", "svd", "svd_jacobi", "svd_jacobi_plain",
           "jacobi_route"]

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
                       p > 4n so the SVD only sees the n×n factor.
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
        if matrix.shape[-1] > 4 * n:
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

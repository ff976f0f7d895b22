"""Linear-algebra cores of PSF subtraction (port of ``vip_tpu.ops.linalg``).

- ``svd_top``: top-k right singular vectors by 'lapack' (QR + small SVD
  for tall matrices), 'eigen' (Gram ``eigh`` trick) or 'randsvd' (Halko).
- ``matrix_scaling_jax``: sklearn.preprocessing.scale semantics.
- ``project_subtract``: SVD → project → reconstruct → residual.
- ``svd``: ``torch.linalg.svd`` with cuSOLVER's QR-based ``gesvd`` on
  CUDA tensors; every SVD of the port goes through it.

vip_tpu left these to XLA and has no Pallas code here; on the card they
stay ``torch.matmul`` and ``torch.linalg`` (cuBLAS/cuSOLVER).
"""

import torch

__all__ = ["svd_top", "matrix_scaling_jax", "project_subtract",
           "randomized_svd", "svd"]


def svd(A, full_matrices=False):
    """``torch.linalg.svd(A, full_matrices)``; on a CUDA tensor with the
    QR-based cuSOLVER routine ``gesvd``.

    PyTorch's default CUDA routine is the Jacobi ``gesvdj``. On the golden
    NACO replica in float32 its top singular vector is as close to the
    float64 one as gesvd's in angle (4.6e-7 against 2.3e-7), but its error
    is not spread like a rounding error: the full-frame PCA frame came out
    1.419e-01 from VIP's golden against 1.425e-03 with gesvd, and the
    annular one 3.465e-02 against 2.064e-03, where the same float32 code
    on a CPU gives 1.287e-03 and 1.487e-03 (ROADMAP.md Queue 3, F2; NVIDIA
    H100 80GB HBM3 at 700 W, ``chip_smoke.py --f2``).
    """
    if A.is_cuda:
        return torch.linalg.svd(A, full_matrices=full_matrices,
                                driver="gesvd")
    return torch.linalg.svd(A, full_matrices=full_matrices)


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
        Q, _ = torch.linalg.qr(A.T @ Q)
        Q, _ = torch.linalg.qr(A @ Q)
    Q, _ = torch.linalg.qr(Q)
    B = Q.T @ A
    Ub, S, Vh = svd(B)
    U = Q @ Ub
    U, S, Vh = U[:, :ncomp], S[:ncomp], Vh[:ncomp]
    if transpose:
        return Vh.T, S, U.T
    return U, S, Vh


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
            Q, R = torch.linalg.qr(matrix.mT)
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
        e, EV = torch.linalg.eigh(C)
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

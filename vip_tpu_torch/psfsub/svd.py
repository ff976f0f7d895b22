"""SVD front end (port of ``vip_tpu.psfsub.svd``: ``MODE_TO_METHOD``,
``svd_wrapper`` and ``get_eigenvectors``).

VIP's ten backend modes map onto the three methods of
``vip_tpu_torch.ops.linalg.svd_top``, which run on the matrix's device.
``SVDecomposer`` (CEVR) is not ported yet.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..ops.linalg import matrix_scaling_jax, svd_top
from ..ops.median import nanmedian_plain

__all__ = ["svd_wrapper", "get_eigenvectors", "MODE_TO_METHOD"]

MODE_TO_METHOD = {
    "lapack": "lapack",
    "cupy": "lapack",
    "pytorch": "lapack",
    "eigen": "eigen",
    "eigencupy": "eigen",
    "eigenpytorch": "eigen",
    "randsvd": "randsvd",
    "randcupy": "randsvd",
    "randpytorch": "randsvd",
    "arpack": "randsvd",
}


def svd_wrapper(matrix, mode, ncomp, verbose=False, full_output=False,
                random_state=None, to_numpy=True, left_eigv=False):
    """Top-``ncomp`` SVD in vip_tpu's output orientation (vip_tpu
    svd.py:48): V (ncomp, n_px) by default, (U, S, V) with
    ``full_output``, U with ``left_eigv``. Randomized modes draw their
    sketch from a ``torch.Generator`` seeded by ``random_state`` (an int,
    a numpy RandomState/Generator, or 0). Numpy results with ``to_numpy``,
    tensors on the matrix's device otherwise."""
    matrix = as_tensor(matrix)
    if matrix.ndim != 2:
        raise TypeError("Input matrix is not a 2d array")
    if ncomp > min(matrix.shape[0], matrix.shape[1]):
        msg = "{} PCs cannot be obtained from a matrix with size [{},{}]."
        msg += " Increase the size of the patches or request less PCs"
        raise RuntimeError(msg.format(ncomp, matrix.shape[0], matrix.shape[1]))
    method = MODE_TO_METHOD.get(mode)
    if method is None:
        raise ValueError("The SVD `mode` is not recognized")

    generator = None
    if method == "randsvd":
        if isinstance(random_state, (int, np.integer)):
            seed = int(random_state)
        elif isinstance(random_state, np.random.RandomState):
            seed = int(random_state.randint(2 ** 31))
        elif isinstance(random_state, np.random.Generator):
            seed = int(random_state.integers(2 ** 31))
        else:
            seed = 0
        generator = torch.Generator(device=matrix.device).manual_seed(seed)

    U, S, V = svd_top(matrix, int(ncomp), method=method, generator=generator,
                      full_output=True)
    if verbose:
        print(f"Done SVD/PCA with the {method} method on {matrix.device}")
    if to_numpy:
        U, S, V = (t.cpu().numpy() for t in (U, S, V))
    if full_output:
        return U, S[: int(ncomp)], V
    return U if left_eigv else V


def get_eigenvectors(ncomp, data, svd_mode, mode="noise", noise_error=1e-3,
                     cevr=0.9, max_evs=None, data_ref=None, debug=False,
                     collapse=False, scaling=None, left_eigv=False):
    """``ncomp`` principal components of ``data_ref`` (default ``data``),
    with ``ncomp="auto"`` chosen by the decay of the residual noise
    (``mode="noise"``) or by the cumulative explained variance ratio
    (``mode="cevr"``) (vip_tpu svd.py:106-177). With ``left_eigv`` the
    left singular vectors, as (ncomp, n) rows. Returns a tensor on the
    data's device."""
    data = as_tensor(data)
    no_dataref = data_ref is None
    data_ref = data if no_dataref else as_tensor(data_ref, data.device,
                                                  data.dtype)
    if max_evs is None:
        max_evs = min(data_ref.shape[0], data_ref.shape[1])
    if ncomp is None:
        raise ValueError("ncomp must be an integer or `auto`")

    if ncomp == "auto":
        ncomp = 0
        V_big = svd_wrapper(data_ref, svd_mode, max_evs, False,
                            to_numpy=False)
        if mode == "noise":
            data_ref_sc = matrix_scaling_jax(data_ref, scaling)
            data_sc = matrix_scaling_jax(data, scaling)
            V_sc = svd_wrapper(data_ref_sc, svd_mode, max_evs, False,
                               to_numpy=False)
            px_noise = []
            px_noise_decay = 1
            while px_noise_decay >= noise_error:
                ncomp += 1
                V = V_sc[:ncomp]
                if no_dataref:
                    reconstructed = (data_sc @ V.T) @ V
                else:
                    reconstructed = ((V @ data_sc).T @ V).T
                residuals = data_sc - reconstructed
                if collapse:
                    residuals = nanmedian_plain(residuals, 0, propagate=True)
                curr_noise = float(torch.std(residuals, correction=0))
                px_noise.append(curr_noise)
                if ncomp > 1:
                    px_noise_decay = px_noise[-2] - curr_noise
            V = V_big[:ncomp]
        elif mode == "cevr":
            data_sc = matrix_scaling_jax(data, scaling)
            _, S, _ = svd_wrapper(data_sc, svd_mode, min(data_sc.shape), False,
                                  full_output=True)
            exp_var = (S ** 2) / (S.shape[0] - 1)
            ratio_cumsum = np.cumsum(exp_var / np.sum(exp_var))
            ncomp = int(np.searchsorted(ratio_cumsum, cevr) + 1)
            V = V_big[:ncomp]
        if debug:
            print("ncomp", ncomp)
    else:
        ncomp = min(ncomp, min(data_ref.shape[0], data_ref.shape[1]))
        V = svd_wrapper(data_ref, svd_mode, ncomp, verbose=False,
                        to_numpy=False, left_eigv=left_eigv)
        if left_eigv:
            V = V.T
    return V

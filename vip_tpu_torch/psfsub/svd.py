"""SVD front end (port of ``vip_tpu.psfsub.svd``: ``MODE_TO_METHOD`` and
``svd_wrapper``).

VIP's ten backend modes map onto the three methods of
``vip_tpu_torch.ops.linalg.svd_top``, which run on the matrix's device.
``SVDecomposer`` (CEVR) is not ported yet.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..ops.linalg import svd_top

__all__ = ["svd_wrapper", "MODE_TO_METHOD"]

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

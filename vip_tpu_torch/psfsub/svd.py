"""SVD front end (port of ``vip_tpu.psfsub.svd``: ``MODE_TO_METHOD``,
``svd_wrapper``, ``get_eigenvectors``, ``randomized_svd_gpu`` and
``SVDecomposer``).

VIP's ten backend modes map onto the three methods of
``vip_tpu_torch.ops.linalg.svd_top``, which run on the matrix's device.
``SVDecomposer`` takes 2-d matrices, 3-d cubes, and 4-d cubes with a
``scale_list`` (the channels rescaled to align the speckles, one batched
zoom a channel, then the z·n frames decomposed).
"""

import numpy as np
import torch

from ..config import check_array, sep, time_ini, timing
from ..config.device import as_tensor
from ..ops.linalg import matrix_scaling_jax, randomized_svd, svd_top
from ..ops.median import nanmedian_plain

__all__ = ["SVDecomposer", "svd_wrapper", "get_eigenvectors",
           "randomized_svd_gpu", "MODE_TO_METHOD"]

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


def randomized_svd_gpu(M, n_components, n_oversamples=10, n_iter="auto",
                       transpose="auto", random_state=0, lib="jax"):
    """Randomized SVD (Halko et al.) of a matrix on its device (numpy
    input on :func:`~vip_tpu_torch.get_device`): (U, S, Vh) of
    ``n_components`` (vip_tpu svd.py:95), through
    ``ops.linalg.randomized_svd``. ``n_iter="auto"`` takes 7 power
    iterations when ``n_components`` is under a tenth of the smaller side,
    else 4. The Gaussian sketch is drawn from a ``torch.Generator`` on
    the matrix's device seeded by ``random_state`` (None as 0), so its
    draws are not vip_tpu's threefry ones. As in vip_tpu, ``transpose``
    changes nothing (a matrix wider than tall is always decomposed
    through its transpose) and neither does ``lib``: its default "jax"
    named vip_tpu's backend; every value runs the same torch code on the
    card."""
    M = as_tensor(M)
    if n_iter == "auto":
        n_iter = 7 if n_components < 0.1 * min(M.shape) else 4
    generator = torch.Generator(device=M.device).manual_seed(
        int(random_state or 0))
    return randomized_svd(M, int(n_components), n_oversamples=n_oversamples,
                          n_iter=int(n_iter), generator=generator)


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


class SVDecomposer:
    """SVD of a 2-d matrix or a 3-d cube ('fullfr' or 'annular') with the
    cumulative explained variance ratio (CEVR) tools (vip_tpu
    svd.py:180). The decomposition runs on the data's device; the ratios
    are host numpy. pandas is imported only by :meth:`get_cevr`, which
    returns tables, and matplotlib only for its plot."""

    def __init__(self, data, mode="fullfr", inrad=None, outrad=None,
                 svd_mode="lapack", scaling="temp-standard", scale_list=None,
                 verbose=True):
        check_array(data, (2, 3, 4), msg="data")
        self.data = data
        self.mode = mode
        self.svd_mode = svd_mode
        self.inrad = inrad
        self.outrad = outrad
        self.scaling = scaling
        self.scale_list = scale_list
        self.verbose = verbose
        if self.mode == "annular":
            if inrad is None:
                raise ValueError("`inrad` must be a positive integer")
            if outrad is None:
                raise ValueError("`outrad` must be a positive integer")
        if self.verbose:
            print(sep)

    def generate_matrix(self):
        """Build (and scale) the matrix from ``data``."""
        from ..var.shapes import prepare_matrix

        start_time = time_ini(False)
        if self.data.ndim == 2:
            print("`data` is already a 2d array")
            self.matrix = matrix_scaling_jax(as_tensor(self.data),
                                             self.scaling)
        else:
            cube_ = self.data
            if self.data.ndim == 4:
                from ..preproc.cosmetics import cube_crop_frames
                from ..preproc.rescaling import _scwave, check_scal_vector

                if self.scale_list is None:
                    raise ValueError("`scale_list` must be provided when "
                                     "`data` is a 4D array")
                data = as_tensor(self.data)
                z, n_frames, y_in, x_in = data.shape
                scale_list = check_scal_vector(self.scale_list)
                if not scale_list.shape[0] == z:
                    raise ValueError(f"`scale_list` length is "
                                     f"{scale_list.shape[0]} instead of {z}")
                if self.verbose:
                    print("Rescaling the spectral channels to align the "
                          "speckles")
                big = _scwave(data, scale_list, collapse=None)[0]
                big = cube_crop_frames(big, size=y_in, verbose=False)
                cube_ = big.transpose(0, 1).reshape(z * n_frames, y_in, x_in)
                self.cube4dto3d_shape = tuple(cube_.shape)
            result = prepare_matrix(cube_, self.scaling, mode=self.mode,
                                    inner_radius=self.inrad,
                                    outer_radius=self.outrad,
                                    verbose=self.verbose)
            if self.mode == "annular":
                self.matrix, pxind = result
                self.yy, self.xx = pxind
            else:
                self.matrix = result
        if self.verbose:
            timing(start_time)

    def run(self):
        """Decompose the matrix (full SVD, all components kept)."""
        start_time = time_ini(False)
        if not hasattr(self, "matrix"):
            self.generate_matrix()
        max_pcs = min(self.matrix.shape[0], self.matrix.shape[1])
        self.u, self.s, self.v = svd_wrapper(self.matrix, self.svd_mode,
                                             max_pcs, verbose=self.verbose,
                                             full_output=True)
        if self.verbose:
            timing(start_time)

    def _ratios(self):
        """Explained variance ratio and its cumulative sum, from the
        singular values."""
        if not hasattr(self, "v"):
            self.run()
        if self.verbose:
            print("Computing the cumulative explained variance ratios")
        exp_var = (self.s ** 2) / (self.s.shape[0] - 1)
        self.explained_variance_ratio = exp_var / np.sum(exp_var)
        self.cevr = np.cumsum(self.explained_variance_ratio)

    def get_cevr(self, ncomp_list=None, plot=True, plot_save=False,
                 plot_dpi=90, plot_truncation=None):
        """Table (pandas) of the explained variance ratio and the CEVR of
        every component, or of those in ``ncomp_list``."""
        from pandas import DataFrame

        start_time = time_ini(False)
        self._ratios()
        self.ncomp_list = ncomp_list
        df_allks = DataFrame({"ncomp": range(1, self.s.shape[0] + 1),
                              "expvar_ratio": self.explained_variance_ratio,
                              "cevr": self.cevr})
        self.table_cevr = df_allks
        if plot:
            self._plot(plot_save, plot_dpi, plot_truncation)
        if self.ncomp_list is not None:
            cevr_klist = [self.cevr[k - 1] for k in self.ncomp_list]
            expvar_ratio_klist = [self.explained_variance_ratio[k - 1]
                                  for k in self.ncomp_list]
            df_klist = DataFrame({"ncomp": self.ncomp_list,
                                  "exp_var_ratio": expvar_ratio_klist,
                                  "cevr": cevr_klist})
            self.cevr_ncomp = cevr_klist
            self.table_cevr_ncomp = df_klist
            if self.verbose:
                timing(start_time)
            return df_klist
        if self.verbose:
            timing(start_time)
        return df_allks

    def _plot(self, plot_save, plot_dpi, plot_truncation):
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 5), dpi=plot_dpi)
        if plot_truncation is not None:
            ax1 = plt.subplot2grid((1, 3), (0, 0), colspan=2, fig=fig)
        else:
            ax1 = fig.add_subplot(111)
        ax1.step(range(self.explained_variance_ratio.shape[0]),
                 self.explained_variance_ratio, where="mid",
                 label="Individual EVR")
        ax1.plot(self.cevr, ".-", label="Cumulative EVR")
        ax1.legend(loc="best", frameon=False)
        ax1.set_ylabel("Explained variance ratio (EVR)")
        ax1.set_xlabel("Principal components")
        if plot_truncation is not None:
            ax2 = plt.subplot2grid((1, 3), (0, 2), colspan=1, fig=fig)
            ax2.step(range(plot_truncation),
                     self.explained_variance_ratio[:plot_truncation],
                     where="mid")
            ax2.plot(self.cevr[:plot_truncation], ".-")
            ax2.set_xlabel("Principal components")
            ax2.grid(linestyle="solid", alpha=0.2)
            ax2.set_xlim(-2, plot_truncation + 2)
            ax2.set_ylim(0, 1)
        if plot_save:
            plt.savefig("figure.pdf", dpi=300, bbox_inches="tight")

    def cevr_to_ncomp(self, cevr=0.9):
        """Number of PCs reaching a given CEVR (a float, or a tuple of
        them)."""
        if not hasattr(self, "cevr"):
            self._ratios()
        if isinstance(cevr, float):
            return int(np.searchsorted(self.cevr, cevr) + 1)
        elif isinstance(cevr, tuple):
            return [int(np.searchsorted(self.cevr, c) + 1) for c in cevr]
        return cevr

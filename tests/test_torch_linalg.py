"""Port's linear algebra (ops/linalg.py, var/shapes.py) against vip_tpu on
the CPU at float64.

Singular and eigen vectors are defined up to sign, so the PCs are compared
as projectors VᵀV. Scaling and projections are the same float64 sums in
another library: 1e-12 relative. The SVDs come from other LAPACK routines;
their projectors agree to ~1e-13 on these well-separated spectra, held at
1e-10.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

import jax
import jax.numpy as jnp

from vip_tpu.ops import linalg as jlin
from vip_tpu.var import shapes as jshapes
from vip_tpu_torch.convert import draws_from_numpy
from vip_tpu_torch.ops import linalg
from vip_tpu_torch.var import shapes

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


SVD_TOL = 1e-10


def _matrix(n, p, seed=0):
    """Low-rank-plus-noise matrix with a decaying spectrum (PCA-like)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, 6)) * np.array([50, 20, 9, 4, 2, 1.0])
    return base @ rng.standard_normal((6, p)) + 0.1 * rng.standard_normal(
        (n, p))


def _close(got, ref, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("scaling", [None, "temp-mean", "spat-mean",
                                     "temp-standard", "spat-standard"])
def test_matrix_scaling_vs_vip_tpu(scaling):
    M = _matrix(12, 40)
    M[:, 3] = 7.0                      # zero temporal variance
    M[5] = -2.0                        # zero spatial variance
    ref = np.asarray(jlin.matrix_scaling_jax(jnp.asarray(M), scaling))
    _close(linalg.matrix_scaling_jax(torch.from_numpy(M), scaling), ref,
           1e-12)
    _close(shapes.matrix_scaling(M, scaling), jshapes.matrix_scaling(
        M, scaling), 1e-12)


def test_matrix_scaling_rejects_unknown_mode():
    with pytest.raises(ValueError):
        linalg.matrix_scaling_jax(torch.zeros((2, 2)), "nope")


@pytest.mark.parametrize("shape", [(10, 80), (20, 30)])   # QR path / direct
@pytest.mark.parametrize("method", ["lapack", "eigen"])
def test_svd_top_projector_vs_vip_tpu(method, shape):
    M = _matrix(*shape, seed=shape[1])
    ncomp = 4
    Uj, Sj, Vj = (np.asarray(a) for a in jlin.svd_top(
        jnp.asarray(M), ncomp, method=method, full_output=True))
    U, S, V = linalg.svd_top(torch.from_numpy(M), ncomp, method=method,
                             full_output=True)
    _close(S, Sj, SVD_TOL)
    _close(V.T @ V, Vj.T @ Vj, SVD_TOL)
    assert U.shape == Uj.shape
    V_only = linalg.svd_top(torch.from_numpy(M), ncomp, method=method)
    _close(V_only.T @ V_only, Vj.T @ Vj, SVD_TOL)


@pytest.mark.parametrize("shape", [(10, 80), (60, 12)])   # wide / tall
def test_randsvd_with_vip_tpu_draw(shape):
    M = _matrix(*shape, seed=3)
    ncomp = 3
    n, p = shape
    # vip_tpu's sketch: jax.random.normal(PRNGKey(0), (A.shape[1], k)),
    # A = Mᵀ for wide matrices (ops/linalg.py:60-65)
    k = min(ncomp + 10, min(n, p))
    omega = np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (min(n, p), k), dtype=jnp.float64))
    Vj = np.asarray(jlin.svd_top(jnp.asarray(M), ncomp, method="randsvd"))
    V = linalg.svd_top(torch.from_numpy(M), ncomp, method="randsvd",
                       omega=draws_from_numpy(omega))
    _close(V.T @ V, Vj.T @ Vj, SVD_TOL)
    with pytest.raises(ValueError):
        linalg.randomized_svd(torch.from_numpy(M), ncomp,
                              omega=torch.zeros((2, 2), dtype=torch.float64))


def test_randsvd_generator_is_deterministic():
    M = torch.from_numpy(_matrix(10, 80, seed=4))
    a = linalg.svd_top(M, 3, method="randsvd")
    b = linalg.svd_top(M, 3, method="randsvd",
                       generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("with_sig", [False, True])
def test_project_subtract_vs_vip_tpu(with_ref, with_sig):
    M = _matrix(14, 60, seed=5)
    ref_m = _matrix(9, 60, seed=6) if with_ref else None
    sig = 0.01 * _matrix(14, 60, seed=7) if with_sig else None
    rj, cj, Vj = jlin.project_subtract(
        jnp.asarray(M), None if ref_m is None else jnp.asarray(ref_m), 4,
        method="lapack", matrix_sig=None if sig is None else jnp.asarray(sig),
        full_output=True)
    r, c, V = linalg.project_subtract(
        torch.from_numpy(M), None if ref_m is None else torch.from_numpy(
            ref_m), 4, method="lapack",
        matrix_sig=None if sig is None else torch.from_numpy(sig),
        full_output=True)
    _close(r, np.asarray(rj), SVD_TOL)
    _close(c, np.asarray(cj), SVD_TOL)


@pytest.mark.parametrize("mode", ["in", "out"])
def test_mask_circle_and_prepare_matrix_vs_vip_tpu(mode):
    rng = np.random.default_rng(8)
    cube = rng.standard_normal((5, 21, 20))
    _close(shapes.mask_circle(cube, 6, mode=mode, fillwith=-1.0),
           jshapes.mask_circle(cube, 6, mode=mode, fillwith=-1.0), 0)
    np.testing.assert_array_equal(
        shapes.mask_circle(cube, 6, output="bool_mask").numpy(),
        jshapes.mask_circle(cube, 6, output="bool_mask"))
    for disc in (False, True):
        ref = jshapes.prepare_matrix(cube, "temp-mean", 4, verbose=False,
                                     discard_mask_pix=disc)
        got = shapes.prepare_matrix(cube, "temp-mean", 4, verbose=False,
                                    discard_mask_pix=disc)
        _close(got, ref, 1e-12)
    got = shapes.reshape_matrix(got[:, :0].new_zeros((5, 420)), 21, 20)
    assert tuple(got.shape) == (5, 21, 20)

"""Port's LOCI solvers (``ops.lsq_solvers``) against vip_tpu and scipy on
the CPU at float64, like tests/test_lsq_solvers.py.

- Each solver against vip_tpu on the same segment at 1e-10 of max(|ref|,
  1), a frame with an empty library (its column of coefficients zero)
  included, and with the masked Grams built in chunks of a few frames.
- Each against the scipy call VIP makes a frame (``lstsq(cond=tol)``,
  ``nnls``, ``lsq_linear(bounds=(0, 1))``) at the tolerances of
  tests/test_lsq_solvers.py.
- ``loci_segment_residuals`` for each solver against vip_tpu.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy as sp
import threadpoolctl
import torch

import vip_tpu_torch
from vip_tpu.ops import lsq_solvers as jls
from vip_tpu_torch.ops import lsq_solvers as tls

torch.set_num_threads(1)

TOL = 1e-10
SOLVERS = ("masked_lstsq_coeffs", "batched_nnls_coeffs",
           "batched_box_lsq_coeffs")


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def segment():
    """tests/test_lsq_solvers.py's segment, frame 3 with an empty library."""
    rng = np.random.default_rng(0)
    n, p, po = 25, 180, 420
    F = rng.standard_normal((n, p))
    Fo = rng.standard_normal((n, po)) + 2.0 * rng.standard_normal((1, po))
    masks = np.zeros((n, n), bool)
    for i in range(n):
        k = rng.integers(5, n - 1)
        sel = rng.choice([j for j in range(n) if j != i], size=k,
                         replace=False)
        masks[i, sel] = True
    masks[3] = False
    return F, Fo, masks


def _args(name):
    return (1e-2,) if name == "masked_lstsq_coeffs" else ()


def _err(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("name", SOLVERS)
def test_solver_vs_vip_tpu(segment, monkeypatch, name, chunked):
    _, Fo, masks = segment
    G = Fo @ Fo.T
    if chunked:
        monkeypatch.setattr(tls, "_GRAM_BUDGET_BYTES",
                            3 * tls._GRAM_COPIES * 25 * 25 * 8)
    ref = getattr(jls, name)(jnp.asarray(G), jnp.asarray(masks),
                             *_args(name))
    got = getattr(tls, name)(torch.as_tensor(G), torch.as_tensor(masks),
                             *_args(name))
    assert _err(got, ref) <= TOL
    assert torch.all(got[~torch.as_tensor(masks)] == 0)
    assert torch.all(got[3] == 0)


def _scipy(name, A, b):
    if name == "masked_lstsq_coeffs":
        return sp.linalg.lstsq(A, b, cond=1e-2)[0]
    if name == "batched_nnls_coeffs":
        return sp.optimize.nnls(A, b)[0]
    return sp.optimize.lsq_linear(A, b, bounds=(0, 1), method="trf",
                                  lsq_solver="lsmr")["x"]


@pytest.mark.parametrize("name", SOLVERS)
def test_solver_vs_scipy(segment, name):
    _, Fo, masks = segment
    got = getattr(tls, name)(torch.as_tensor(Fo @ Fo.T),
                             torch.as_tensor(masks), *_args(name)).numpy()
    for i in range(Fo.shape[0]):
        ind = np.where(masks[i])[0]
        if ind.size == 0:
            continue
        A, b = Fo[ind].T, Fo[i]
        ref = _scipy(name, A, b)
        if name == "batched_box_lsq_coeffs":
            # scipy stops at its own tolerance (tests/test_lsq_solvers.py)
            np.testing.assert_allclose(got[i, ind], ref, atol=1e-4)
            assert np.sum((A @ got[i, ind] - b) ** 2) \
                <= np.sum((A @ ref - b) ** 2) * (1 + 1e-9) + 1e-12
            assert np.all((got[i] >= 0) & (got[i] <= 1))
        else:
            np.testing.assert_allclose(got[i, ind], ref, atol=1e-8)


@pytest.mark.parametrize("solver", ["lstsq", "nnls", "lsq"])
def test_segment_residuals_vs_vip_tpu(segment, solver):
    F, Fo, masks = segment
    ref = jls.loci_segment_residuals(jnp.asarray(F), jnp.asarray(Fo),
                                     jnp.asarray(masks), 1e-2, solver=solver)
    got = tls.loci_segment_residuals(torch.as_tensor(F), torch.as_tensor(Fo),
                                     torch.as_tensor(masks), 1e-2,
                                     solver=solver)
    assert _err(got, ref) <= TOL
    with pytest.raises(ValueError, match="solver"):
        tls.loci_segment_residuals(torch.as_tensor(F), torch.as_tensor(Fo),
                                   torch.as_tensor(masks), 1e-2, solver="x")


def test_segment_residuals_empty_mask_column_ignored(segment):
    """A frame in no frame's library gets zero coefficients everywhere
    (tests/test_lsq_solvers.py:106)."""
    F, Fo, masks = segment
    masks = masks.copy()
    masks[:, 7] = False
    res = tls.loci_segment_residuals(torch.as_tensor(F), torch.as_tensor(Fo),
                                     torch.as_tensor(masks), 1e-2,
                                     solver="lstsq").numpy()
    i = 2
    ind = np.where(masks[i])[0]
    ref = sp.linalg.lstsq(Fo[ind].T, Fo[i], cond=1e-2)[0]
    np.testing.assert_allclose(res[i], F[i] - ref @ F[ind], atol=1e-9)

"""The building blocks of the port's annular PCA against vip_tpu on the CPU
at float64.

- Geometry (``get_annulus_segments``, ``resolve_n_segments``,
  ``_define_annuli``): host numpy in both, so exactly equal.
- ``get_eigenvectors``: the same float64 SVDs from another library.
  Singular vectors are defined up to sign, so projectors VᵀV (or the
  residuals) are compared, at 1e-10 of max(|ref|, 1).
- ``ops.annular``: per-frame eigh/SVD of small libraries in another
  LAPACK; the residuals are held at 1e-8 of max(|ref|, 1), vip_tpu's own
  host-vs-Gram bound (vip_tpu/psfsub/pca_local.py:632-633). The subspace
  iteration is fed vip_tpu's own ``jax.random.PRNGKey(7)`` draw.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

import jax
import jax.numpy as jnp

from vip_tpu.ops import annular as jann
from vip_tpu.preproc import derotation as jder
from vip_tpu.psfsub import svd as jsvd
from vip_tpu.var import shapes as jshapes
from vip_tpu_torch.convert import draws_from_numpy
from vip_tpu_torch.ops import annular
from vip_tpu_torch.preproc import derotation
from vip_tpu_torch.psfsub import svd
from vip_tpu_torch.var import shapes

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


SVD_TOL = 1e-10
RES_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """vip_tpu's small per-frame LAPACK calls run on scipy's OpenBLAS,
    whose threads spin while they wait: beside other test workers on the
    same cores, that made vip_tpu's annular PCA of a 40x48x48 cube take
    80 s instead of 0.5 s. One BLAS thread during these modules, as
    ``torch.set_num_threads(1)`` does for the port."""
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _matrix(n, p, seed=0):
    """Low-rank-plus-noise matrix with a decaying spectrum (PCA-like)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, 6)) * np.array([50, 20, 9, 4, 2, 1.0])
    return base @ rng.standard_normal((6, p)) + 0.1 * rng.standard_normal(
        (n, p))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("out", [False, True])
@pytest.mark.parametrize("shape,inner,width,nsegm,theta,fact", [
    ((48, 48), 0, 4, 1, 0, 1),
    ((48, 48), 7.5, 4, 3, 0, 1),
    ((49, 49), 10, 3, 4, 30, 1),
    ((40, 52), 5, 2, 6, 250, 2),
    ((64, 64), 23, 4, 7, 359, 1),
])
def test_annulus_segments_exact(shape, inner, width, nsegm, theta, fact,
                                out):
    ref = jshapes.get_annulus_segments(shape, inner, width, nsegm, theta,
                                       optim_scale_fact=fact, out=out)
    got = shapes.get_annulus_segments(shape, inner, width, nsegm, theta,
                                      optim_scale_fact=fact, out=out)
    assert len(got) == len(ref) == nsegm
    for (gy, gx), (ry, rx) in zip(got, ref):
        np.testing.assert_array_equal(gy, ry)
        np.testing.assert_array_equal(gx, rx)


def test_annulus_segments_val_and_mask_modes():
    frame = np.random.default_rng(2).standard_normal((33, 33))
    for mode in ("val", "mask"):
        ref = jshapes.get_annulus_segments(frame, 6, 5, 3, 10, mode=mode)
        got = shapes.get_annulus_segments(torch.from_numpy(frame), 6, 5, 3,
                                          10, mode=mode)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_resolve_n_segments_exact():
    for args in ((None, 5, 4), (3, 5, 4), ("auto", 12, 4), ("auto", 9, 6),
                 ([1, 2, 3], 3, 4)):
        assert shapes.resolve_n_segments(*args) == \
            jshapes.resolve_n_segments(*args)


@pytest.mark.parametrize("strict", [False, True])
def test_define_annuli_exact(strict):
    angles = np.linspace(0.0, 37.0, 25)
    for ann in range(6):
        for delta_rot in (0.1, 1.0, 8.0):
            args = (angles, ann, 6, 4.0, 2, 4, delta_rot, 3, False, strict)
            assert derotation._define_annuli(*args) == \
                jder._define_annuli(*args)


# ---------------------------------------------------------------------------
# get_eigenvectors
# ---------------------------------------------------------------------------
def _projector(V):
    V = np.asarray(V, np.float64)
    return V.T @ V


@pytest.mark.parametrize("svd_mode", ["lapack", "eigen"])
def test_get_eigenvectors_int_vs_vip_tpu(svd_mode):
    M = _matrix(30, 80)
    ref = jsvd.get_eigenvectors(5, M, svd_mode)
    got = svd.get_eigenvectors(5, torch.from_numpy(M), svd_mode)
    assert tuple(got.shape) == np.shape(ref) == (5, 80)
    assert _err(_projector(got), _projector(ref)) <= SVD_TOL


@pytest.mark.parametrize("mode,kw", [
    ("noise", dict(noise_error=1e-2)),
    ("noise", dict(noise_error=1e-3, collapse=True)),
    ("noise", dict(noise_error=1e-2, scaling="temp-mean")),
    ("cevr", dict(cevr=0.9)),
    ("cevr", dict(cevr=0.99, scaling="spat-standard")),
])
def test_get_eigenvectors_auto_vs_vip_tpu(mode, kw):
    M = _matrix(25, 60, seed=4)
    ref = np.asarray(jsvd.get_eigenvectors("auto", M, "lapack", mode=mode,
                                           **kw))
    got = svd.get_eigenvectors("auto", M, "lapack", mode=mode, **kw)
    assert tuple(got.shape) == ref.shape
    assert _err(_projector(got), _projector(ref)) <= SVD_TOL


def test_get_eigenvectors_left_eigv_vs_vip_tpu():
    M = _matrix(20, 90, seed=6)
    ref = np.asarray(jsvd.get_eigenvectors(4, M, "lapack", left_eigv=True))
    got = svd.get_eigenvectors(4, M, "lapack", left_eigv=True)
    assert tuple(got.shape) == ref.shape == (4, 20)
    # left vectors of M: project the frame axis
    assert _err(_projector(got), _projector(ref)) <= SVD_TOL
    # and the residuals pca_annular forms from them
    res_ref = M - ((ref @ M).T @ ref).T
    res_got = M - ((got @ torch.from_numpy(M)).T @ got).numpy().T
    assert _err(res_got, res_ref) <= SVD_TOL


# ---------------------------------------------------------------------------
# ops.annular
# ---------------------------------------------------------------------------
def _libs(n, thr=6.0, max_frames=12, seed=0):
    """PA-threshold library masks as pca_annular builds them."""
    angles = np.sort(np.random.default_rng(seed).uniform(0, 60, n))
    mask = np.zeros((n, n), bool)
    for fr in range(n):
        mask[fr, jder._find_indices_adi(angles, fr, thr, truncate=True,
                                        max_frames=max_frames)] = True
    return mask


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("method", ["lapack", "eigen"])
def test_batched_patch_residuals_vs_vip_tpu(method, with_ref):
    n, p, ncomp = 24, 70, 4
    M = _matrix(n, p, seed=1)
    M_emp = M - 0.05 * _matrix(n, p, seed=2)
    mask = _libs(n)
    k_eff = np.minimum(ncomp, mask.sum(1) + (5 if with_ref else 0))
    k_eff[3] = 2
    ref_rows = _matrix(5, p, seed=3) if with_ref else None
    r_res, r_V = jann.batched_pca_patch_residuals(
        jnp.asarray(M), jnp.asarray(M_emp), jnp.asarray(mask), ncomp,
        method=method,
        matrix_ref=None if ref_rows is None else jnp.asarray(ref_rows),
        k_eff=jnp.asarray(k_eff))
    g_res, g_V = annular.batched_pca_patch_residuals(
        torch.from_numpy(M), torch.from_numpy(M_emp), mask, ncomp,
        method=method,
        matrix_ref=None if ref_rows is None else torch.from_numpy(ref_rows),
        k_eff=torch.from_numpy(k_eff))
    assert _err(g_res, r_res) <= RES_TOL
    for f in (0, 3, n - 1):
        assert _err(_projector(g_V[f]), _projector(r_V[f])) <= RES_TOL


def _lib_arrays(mask, L):
    n = mask.shape[0]
    idx = np.zeros((n, L), np.int64)
    w = np.zeros((n, L))
    for f in range(n):
        sel = np.flatnonzero(mask[f])
        idx[f, :sel.size] = sel
        w[f, :sel.size] = 1.0
    return idx, w


@pytest.mark.parametrize("method", ["eigh", "subspace"])
def test_batched_patch_residuals_gram_vs_vip_tpu(method):
    n, p, ncomp, L = 40, 90, 5, 16
    M = _matrix(n, p, seed=7)
    M_emp = M - 0.02 * _matrix(n, p, seed=8)
    idx, w = _lib_arrays(_libs(n, max_frames=L - 2), L)
    k_eff = np.minimum(ncomp, w.sum(1).astype(int))
    k_eff[5] = 3
    ref = jann.batched_pca_patch_residuals_gram(
        jnp.asarray(M), jnp.asarray(M_emp), jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(w), ncomp, k_eff=jnp.asarray(k_eff), method=method)
    m = min(L, ncomp + 8)
    sketch = draws_from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(7), (L, m), jnp.float64)))
    got = annular.batched_pca_patch_residuals_gram(
        torch.from_numpy(M), torch.from_numpy(M_emp), idx, w, ncomp,
        k_eff=k_eff, method=method, sketch=sketch)
    assert _err(got, ref) <= RES_TOL
    if method == "eigh":
        # the Gram path equals the masked path (vip_tpu's own contract)
        mask = w.astype(bool)
        lib_mask = np.zeros((n, n), bool)
        for f in range(n):
            lib_mask[f, idx[f, mask[f]]] = True
        masked = annular.batched_pca_patch_residuals(
            torch.from_numpy(M), torch.from_numpy(M_emp), lib_mask, ncomp,
            method="eigen", k_eff=torch.from_numpy(k_eff))[0]
        assert _err(got, masked) <= RES_TOL


def test_subspace_default_sketch_is_seeded():
    G = torch.from_numpy(_matrix(12, 30, seed=9))
    G = G @ G.T
    e1, U1, _ = annular._subspace_topk(G[None], 3)
    e2, U2, _ = annular._subspace_topk(G[None], 3)
    assert torch.equal(e1, e2) and torch.equal(U1, U2)
    e, _ = torch.linalg.eigh(G)
    assert _err(e1[0], e.flip(0)[:3]) <= 1e-12
    with pytest.raises(ValueError):
        annular._subspace_topk(G[None], 3, sketch=torch.zeros((12, 4)))


@pytest.mark.parametrize("method", ["eigh", "subspace"])
def test_resident_annulus_update_vs_vip_tpu(method):
    n, y, ncomp, L = 30, 24, 3, 12
    rng = np.random.default_rng(10)
    cube = _matrix(n, y * y, seed=11).reshape(n, y, y)
    cube_out = rng.standard_normal((n, y, y))
    yy, xx = shapes.get_annulus_segments((y, y), 5, 4, 2, 0)[1]
    flat = (yy * y + xx).astype(np.int64)
    p_pad = 64 * (flat.size // 64 + 1)        # at least one padding column
    flat_pad = np.pad(flat, (0, p_pad - flat.size), constant_values=y * y)
    colmask = np.zeros(p_pad)
    colmask[:flat.size] = 1.0
    idx, w = _lib_arrays(_libs(n, max_frames=L - 1, seed=12), L)
    k_eff = np.minimum(ncomp, w.sum(1).astype(int))
    ref = jann.resident_annulus_update(
        jnp.asarray(cube), jnp.asarray(cube_out),
        jnp.asarray(flat_pad.astype(np.int32)), jnp.asarray(colmask),
        jnp.asarray(idx.astype(np.int32)), jnp.asarray(w),
        jnp.asarray(k_eff), ncomp, method=method)
    m = min(L, ncomp + 8)
    sketch = draws_from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(7), (L, m), jnp.float64)))
    got_out = torch.from_numpy(cube_out.copy())
    got = annular.resident_annulus_update(
        torch.from_numpy(cube), got_out, torch.from_numpy(flat_pad),
        torch.from_numpy(colmask), idx, w, k_eff, ncomp, method=method,
        sketch=sketch)
    assert got is got_out                      # written in place
    assert _err(got, ref) <= RES_TOL
    untouched = np.ones((n, y * y), bool)
    untouched[:, flat] = False
    np.testing.assert_array_equal(got.reshape(n, -1).numpy()[untouched],
                                  cube_out.reshape(n, -1)[untouched])

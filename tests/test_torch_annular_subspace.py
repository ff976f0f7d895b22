"""The resident annular PCA's own building blocks on the CPU, against
their definitions:

- ``pca_local._library_masks`` (every annulus's and frame's library at
  once) equals ``_find_indices_adi`` frame by frame, ties at the
  truncation's cut and non-monotonic angles included, and
  ``_pad_lib_arrays`` lays each library out in frame order;
- ``ops.linalg._orth`` gives orthonormal columns that span the block,
  on ill-conditioned, rank-deficient and zero blocks;
- ``ops.annular._subspace_topk`` runs to its tolerance: on a spectrum
  flat past ncomp, where vip_tpu's fixed 30 steps leave the components
  unconverged, its top-k subspace meets ``torch.linalg.eigh``'s, and it
  works in float64 whatever the Gram's dtype;
- the subspace route of ``batched_pca_patch_residuals_gram`` on float32
  input lands within float64's reach of the exact residuals, far nearer
  than the float32 eigh route.
"""

import numpy as np
import pytest
import torch

from vip_tpu_torch.ops import annular, linalg
from vip_tpu_torch.preproc.derotation import _find_indices_adi
from vip_tpu_torch.psfsub import pca_local

RNG = np.random.default_rng(2121)


def _angles(kind, n):
    if kind == "linear":
        return np.linspace(0.0, 40.0, n)
    if kind == "random":
        return np.sort(RNG.uniform(0.0, 60.0, n))
    if kind == "ties":                 # steps of 0.5 deg: equal |ΔPA| a row
        return np.round(np.linspace(0.0, 20.0, n) * 2) / 2
    return np.concatenate([np.linspace(10.0, 30.0, n // 2),
                           np.linspace(30.0, 5.0, n - n // 2)])


@pytest.mark.parametrize("kind", ["linear", "random", "ties",
                                  "non-monotonic"])
@pytest.mark.parametrize("n,max_frames", [(7, 3), (60, 20), (61, 200)])
def test_library_masks_are_find_indices_adi(kind, n, max_frames):
    angles = _angles(kind, n)
    thresholds = [0.0, 0.3, 1.7, 6.0, 25.0]
    masks = pca_local._library_masks(angles, thresholds, max_frames)
    assert masks.shape == (len(thresholds), n, n)
    for a, thr in enumerate(thresholds):
        for f in range(n):
            want = np.zeros(n, bool)
            want[_find_indices_adi(angles, f, thr, truncate=True,
                                   max_frames=max_frames)] = True
            np.testing.assert_array_equal(masks[a, f].numpy(), want)


def test_pad_lib_arrays_lays_out_each_library_in_frame_order():
    masks = torch.as_tensor(RNG.random((3, 9, 9)) < 0.4)
    L_pad = int(masks.sum(-1).max()) + 2
    idx, w = pca_local._pad_lib_arrays(masks, L_pad, torch.float64)
    assert idx.shape == w.shape == (3, 9, L_pad) and w.dtype == torch.float64
    for a in range(3):
        for f in range(9):
            sel = np.flatnonzero(masks[a, f].numpy())
            np.testing.assert_array_equal(idx[a, f, :sel.size].numpy(), sel)
            assert not idx[a, f, sel.size:].any()
            assert w[a, f].tolist() == [1.0] * sel.size \
                + [0.0] * (L_pad - sel.size)


def _block(cond, rank=None, L=80, m=12):
    U = torch.linalg.qr(torch.as_tensor(RNG.standard_normal((L, m))))[0]
    V = torch.linalg.qr(torch.as_tensor(RNG.standard_normal((m, m))))[0]
    s = torch.logspace(0, -np.log10(cond), m, dtype=torch.float64)
    if rank is not None:
        s[rank:] = 0
    return (U * s) @ V.T


@pytest.mark.parametrize("cond,rank", [(1e2, None), (1e12, None),
                                       (1e3, 5)])
def test_orth_gives_an_orthonormal_basis_of_the_block(cond, rank):
    B = _block(cond, rank)
    Q = linalg._orth(B[None])[0]
    Ub = torch.linalg.svd(B)[0][:, :rank or 5]
    # the block's span is kept (its dominant part, where ill-conditioned)
    assert (Ub - Q @ (Q.T @ Ub)).abs().max() <= 1e-10
    if rank is None:
        err = (Q.T @ Q - torch.eye(12, dtype=Q.dtype)).abs().max()
        assert err <= 1e-12
    else:
        # rank unit columns in the span, the others outside it
        inside = (Ub.T @ Q).norm(dim=0).sort().values
        want = torch.tensor([0.0] * (12 - rank) + [1.0] * rank,
                            dtype=Q.dtype)
        assert (inside - want).abs().max() <= 1e-10
    # one pass spans the dominant directions too
    Q1 = torch.linalg.qr(linalg._orth(B[None], passes=1)[0])[0]
    assert (Ub[:, :3] - Q1 @ (Q1.T @ Ub[:, :3])).abs().max() <= 1e-8


def test_orth_keeps_a_zero_block_zero():
    Q = linalg._orth(torch.zeros((2, 30, 6), dtype=torch.float64))
    assert torch.equal(Q, torch.zeros_like(Q))


def _flat_gram(L=120, rank=80, ncomp=10):
    """A PSD Gram whose spectrum falls steeply to ncomp, then flattens
    just below (ratio 0.995 a step), as the outer annuli's do."""
    lam = np.concatenate([np.logspace(4, 1, ncomp),
                          9 * 0.995 ** np.arange(rank - ncomp)])
    U = np.linalg.qr(RNG.standard_normal((L, rank)))[0]
    return torch.as_tensor((U * lam) @ U.T)


def _residual(G, e, U):
    """max over the pairs of ‖G u − θ u‖ / θ₁."""
    return float(((G @ U - U * e).norm(dim=0) / e[0]).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_subspace_topk_runs_to_its_tolerance(dtype, monkeypatch):
    G = _flat_gram()
    e = torch.linalg.eigvalsh(G).flip(0)[:10]
    e_top, U_top, met = annular._subspace_topk(G[None].to(dtype), 10)
    assert e_top.dtype == U_top.dtype == dtype and bool(met.all())
    e64, U64 = e_top[0].double(), U_top[0].double()
    if dtype == torch.float64:
        # the stop's own test, on the pairs it returns
        assert _residual(G, e64, U64) <= linalg.SUBSPACE_TOL
    assert float((U64.T @ U64 - torch.eye(10, dtype=U64.dtype)).abs().max()) \
        <= (1e-12 if dtype == torch.float64 else 1e-6)
    assert float(((e64 - e) / e[0]).abs().max()) <= \
        (linalg.SUBSPACE_TOL if dtype == torch.float64 else 1e-6)
    # vip_tpu's fixed 30 steps stop far short of it here
    monkeypatch.setattr(linalg, "SUBSPACE_MAX_STEPS", 30)
    e_cap, U_cap, met = annular._subspace_topk(G[None], 10)
    assert not bool(met.any())
    assert _residual(G, e_cap[0], U_cap[0]) > 10 * linalg.SUBSPACE_TOL


def test_subspace_route_on_float32_lands_near_the_exact_residuals():
    n, p, ncomp, L = 64, 300, 8, 40
    base = RNG.standard_normal((n, 24)) @ RNG.standard_normal((24, p))
    M64 = torch.as_tensor(base * np.logspace(0, -2, p)
                          + 1e-3 * RNG.standard_normal((n, p)))
    M32 = M64.float()
    idx = np.stack([np.delete(np.arange(n), np.arange(f - 3, f + 4) % n)[:L]
                    for f in range(n)])
    w = np.ones((n, L))
    exact = annular.batched_pca_patch_residuals_gram(
        M32.double(), M32.double(), idx, w, ncomp, method="eigh")
    sub = annular.batched_pca_patch_residuals_gram(
        M32, M32, idx, w, ncomp, method="subspace")
    eigh32 = annular.batched_pca_patch_residuals_gram(
        M32, M32, idx, w, ncomp, method="eigh")
    assert sub.dtype == torch.float32
    scale = float(M32.abs().max())
    gap_sub = float((sub.double() - exact).abs().max()) / scale
    gap_32 = float((eigh32.double() - exact).abs().max()) / scale
    assert gap_sub <= 1e-6 and gap_sub < gap_32 / 4

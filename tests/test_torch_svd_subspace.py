"""``svd_top``'s top-ncomp route for large R factors on the CPU:
``ops.linalg.svd_subspace`` (the top-ncomp triplets of a square R from a
float64 subspace iteration on R Rᵀ) and ``_qr_top`` (geqrf, the route,
then Q applied to ncomp columns by ormqr), in float64 against
``torch.linalg.svd``.

The stopping rule holds each returned pair to ‖G u_i − θ_i u_i‖ ≤
τ·σ₁σ_i (τ = ``SUBSPACE_SVD_TOL``), which bounds the angle of the top-k
subspace by ~τ·σ₁σ_k over the gap θ_k − θ_{k+1}: the projectors are held
to ten times that (``_proj_bound``), the singular values to τ·σ₁. Hard
spectra: clustered values inside the top k, a spectrum flat past ncomp,
rank deficiency, σ₁/σ_k of 1e4, a batch. Then the route's predicate, the
fallback to gesvd at the step cap, before it where the residual falls
too slowly to meet it (matrix by matrix in a batch), and on non-finite
input, its spans and counter, the path off the route (QR, svd of R,
Q @ Ur), and ``ops.annular._subspace_topk`` returning what it returned
before the iteration moved to ``ops.linalg``.
"""

import importlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vip_tpu_torch
from vip_tpu_torch.ops import annular, linalg
from vip_tpu_torch.ops.linalg import (SUBSPACE_SVD_MIN_SIDE,
                                      SUBSPACE_SVD_TOL, subspace_route,
                                      svd_subspace, svd_top)

timing = importlib.import_module("vip_tpu_torch.config.timing")


@pytest.fixture(autouse=True)
def _cpu():
    vip_tpu_torch.set_device("cpu")


def _with_spectrum(n, s, seed, batch=()):
    """(*batch, n, n) float64 matrices Q1 diag(s) Q2ᵀ, Q1 and Q2 random
    orthogonal."""
    g = torch.Generator().manual_seed(seed)
    Q1 = torch.linalg.qr(torch.randn((*batch, n, n), generator=g,
                                     dtype=torch.float64))[0]
    Q2 = torch.linalg.qr(torch.randn((*batch, n, n), generator=g,
                                     dtype=torch.float64))[0]
    return (Q1 * torch.as_tensor(s, dtype=torch.float64)) @ Q2.mT


def _clustered(n, k):
    # three clusters inside the top k, a clear gap after the k-th value
    top = np.concatenate([10 * (1 - 1e-6 * np.arange(2)),
                          5 * (1 - 1e-6 * np.arange(2)),
                          3 * (1 - 1e-6 * np.arange(k - 4))])
    return np.concatenate([top, np.logspace(0, -2, n - k)])


def _flat_past(n, k):
    # steep to k, then a tail falling 0.5% a value
    return np.concatenate([np.logspace(3, 1, k),
                           9 * 0.995 ** np.arange(n - k)])


def _rank_deficient(n, k):
    return np.concatenate([np.logspace(2, 0, 3 * k), np.zeros(n - 3 * k)])


def _dynamic(n, k):
    # sigma_1 / sigma_k = 1e4
    return np.concatenate([np.logspace(4, 0, k),
                           0.5 * np.logspace(0, -3, n - k)])


SPECTRA = {"clustered": _clustered, "flat_past_ncomp": _flat_past,
           "rank_deficient": _rank_deficient, "ratio_1e4": _dynamic}


def _proj_bound(s, k):
    """Ten times the angle the stopping rule allows the top-k subspace,
    plus float64 rounding."""
    s1, sk, sk1 = s[0], s[k - 1], s[k]
    return 10 * SUBSPACE_SVD_TOL * s1 * sk / (sk ** 2 - sk1 ** 2) + 1e-12


def _projector(U):
    return U @ U.mT


def _check(R, got, k, s):
    U, S, Vh = got
    U0, S0, Vh0 = torch.linalg.svd(R)
    assert U.shape == (*R.shape[:-2], R.shape[-1], k)
    assert S.shape == (*R.shape[:-2], k)
    assert Vh.shape == (*R.shape[:-2], k, R.shape[-1])
    assert float((S - S0[..., :k]).abs().max()) <= SUBSPACE_SVD_TOL * s[0]
    bound = _proj_bound(s, k)
    assert float((_projector(U) - _projector(U0[..., :k])).abs().max()) \
        <= bound
    assert float((_projector(Vh.mT) - _projector(Vh0[..., :k, :].mT))
                 .abs().max()) <= bound
    # U S Vh is R's rank-k part: R's own right vectors on U's directions
    assert float((U.mT @ R - S[..., None] * Vh).abs().max()) \
        <= 1e-12 * s[0]
    # the stopping rule, on the pairs returned
    G = R @ R.mT
    resid = (G @ U - U * S[..., None, :] ** 2).norm(dim=-2)
    assert bool((resid <= SUBSPACE_SVD_TOL * S[..., :1] * S).all())


@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("name", list(SPECTRA))
def test_route_against_float64_svd(name, k):
    n = 160
    s = SPECTRA[name](n, k)
    R = _with_spectrum(n, s, 31 + k)
    linalg.subspace_matrices = 0
    _check(R, svd_subspace(R, k), k, s)
    assert linalg.subspace_matrices == 1


def test_route_on_a_batch():
    n, k = 120, 8
    specs = [_clustered(n, k), _flat_past(n, k), _dynamic(n, k)]
    R = torch.stack([_with_spectrum(n, s, 40 + i)
                     for i, s in enumerate(specs)]).reshape(3, 1, n, n)
    linalg.subspace_matrices = 0
    U, S, Vh = svd_subspace(R, k)
    assert linalg.subspace_matrices == 3
    for i, s in enumerate(specs):
        _check(R[i, 0], (U[i, 0], S[i, 0], Vh[i, 0]), k, s)


def test_signs_follow_one_rule_and_repeat():
    n, k = 96, 6
    R = _with_spectrum(n, _clustered(n, 10), 50)
    U, S, Vh = svd_subspace(R, k)
    peak = U.abs().argmax(0)
    assert bool((U[peak, torch.arange(k)] > 0).all())
    for a, b in zip((U, S, Vh), svd_subspace(R, k)):
        assert torch.equal(a, b)


def _tall(n, p, s, seed, batch=()):
    """(*batch, n, p) matrices of spectrum s, p > 4n, as svd_top takes
    them."""
    g = torch.Generator().manual_seed(seed)
    Q1 = torch.linalg.qr(torch.randn((*batch, n, n), generator=g,
                                     dtype=torch.float64))[0]
    Q2 = torch.linalg.qr(torch.randn((*batch, p, n), generator=g,
                                     dtype=torch.float64))[0]
    return (Q1 * torch.as_tensor(s, dtype=torch.float64)) @ Q2.mT


@pytest.mark.parametrize("batch", [(), (2,)], ids=["one", "batch"])
def test_svd_top_on_the_route_is_the_gesvd_route(monkeypatch, batch):
    """svd_top('lapack') with the route forced (the CPU never takes it by
    itself) against the QR + gesvd route: the principal components, and
    U, S of full_output."""
    n, p, k = 80, 400, 7
    s = _flat_past(n, k)
    M = _tall(n, p, s, 60, batch)
    V0 = svd_top(M, k)
    U0, S0, _ = svd_top(M, k, full_output=True)
    monkeypatch.setattr(linalg, "subspace_route", lambda *a: True)
    V = svd_top(M, k)
    U, S, V2 = svd_top(M, k, full_output=True)
    assert V.shape == V0.shape == (*batch, k, p)
    assert U.shape == (*batch, n, k) and S.shape == (*batch, k)
    assert torch.equal(V, V2)
    bound = _proj_bound(s, k)
    assert float((_projector(V.mT) - _projector(V0.mT)).abs().max()) <= bound
    assert float((_projector(U) - _projector(U0)).abs().max()) <= bound
    assert float((S - S0).abs().max()) <= SUBSPACE_SVD_TOL * s[0]
    # M = U S V on the top k: Uᵀ M = S V
    # (each row off by its residual over σ_i: at most τ·σ₁)
    assert float((U.mT @ M - S[..., None] * V).abs().max()) \
        <= SUBSPACE_SVD_TOL * s[0]


def _like(shape, dtype=torch.float32, device="cuda"):
    """What the predicate reads of a tensor, without a card."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 ndim=len(shape), shape=torch.Size(shape))


@pytest.mark.parametrize("shape,dtype,device,ncomp,want", [
    ((3900, 84100), torch.float32, "cuda", 20, True),
    ((3900, 84100), torch.float32, "cuda", 5, True),
    ((8, 1000, 9000), torch.float32, "cuda", 10, True),
    ((SUBSPACE_SVD_MIN_SIDE, 84100), torch.float32, "cuda", 20, True),
    ((SUBSPACE_SVD_MIN_SIDE - 1, 84100), torch.float32, "cuda", 20, False),
    ((100, 84100), torch.float32, "cuda", 5, False),
    ((SUBSPACE_SVD_MIN_SIDE, 84100), torch.float32, "cuda", 120, True),
    ((SUBSPACE_SVD_MIN_SIDE, 84100), torch.float32, "cuda", 121, False),
    ((3900, 84100), torch.float64, "cuda", 20, False),
    ((3900, 84100), torch.float32, "cpu", 20, False),
    ((84100,), torch.float32, "cuda", 20, False),
], ids=["single_pass", "ncomp5", "batch", "least_side", "below_side",
        "double_pass_adi", "widest_block", "block_too_wide", "float64",
        "cpu", "1d"])
def test_subspace_route(shape, dtype, device, ncomp, want):
    assert subspace_route(_like(shape, dtype, device), ncomp) is want


def test_step_cap_falls_back_to_gesvd(monkeypatch):
    n, k = 120, 10
    R = _with_spectrum(n, _flat_past(n, k), 70)
    calls = []
    gesvd = linalg._gesvd
    monkeypatch.setattr(linalg, "_gesvd",
                        lambda A: calls.append(A.shape) or gesvd(A))
    monkeypatch.setattr(linalg, "SUBSPACE_SVD_MAX_STEPS", 2)
    linalg.subspace_matrices = 0
    U, S, Vh = svd_subspace(R, k)
    assert calls == [(1, n, n)] and linalg.subspace_matrices == 0
    U0, S0, Vh0 = torch.linalg.svd(R)
    assert torch.equal(U, U0[:, :k]) and torch.equal(S, S0[:k])
    assert torch.equal(Vh, Vh0[:k])


def test_a_flat_spectrum_falls_back_before_the_cap(monkeypatch):
    """Where the ncomp-th value lies inside a flat band (a noise floor),
    the residual cannot reach τ within the cap: the route stops at its
    second test or soon after, and the matrix takes gesvd."""
    n, k = 200, 10
    g = np.random.default_rng(5)
    s = np.concatenate([np.logspace(3, 2, k - 1),
                        np.sort(1 + 1e-3 * g.standard_normal(n - k + 1))
                        [::-1]])
    R = _with_spectrum(n, s, 100)
    steps = []
    orth = linalg._orth
    monkeypatch.setattr(linalg, "_orth",
                        lambda B, passes=3: steps.append(passes)
                        or orth(B, passes))
    linalg.subspace_matrices = 0
    U, S, Vh = svd_subspace(R, k)
    assert linalg.subspace_matrices == 0
    assert len(steps) < linalg.SUBSPACE_SVD_MAX_STEPS // 2
    U0, S0, Vh0 = torch.linalg.svd(R)
    assert torch.equal(U, U0[:, :k]) and torch.equal(S, S0[:k])


def test_a_flat_matrix_leaves_the_others_of_its_batch_running():
    """The early stop is taken matrix by matrix: beside a matrix whose
    ncomp-th value lies in a flat band (sent to gesvd early), one whose
    residual falls slowly but meets the rule well within the cap stays
    on the route and is returned converged."""
    n, k = 200, 10
    g = np.random.default_rng(5)
    flat = np.concatenate([np.logspace(3, 2, k - 1),
                           np.sort(1 + 1e-3 * g.standard_normal(n - k + 1))
                           [::-1]])
    # (σ_65 / σ_10)² = 0.81 a step: ~60 steps to τ
    slow = np.concatenate([np.logspace(3, 2, k), 90 * 0.9995 **
                           np.arange(n - k)])
    R = torch.stack([_with_spectrum(n, flat, 100),
                     _with_spectrum(n, slow, 101)])
    calls = []
    gesvd = linalg._gesvd
    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(linalg, "_gesvd",
                        lambda A: calls.append(A.shape) or gesvd(A))
    try:
        linalg.subspace_matrices = 0
        U, S, Vh = svd_subspace(R, k)
    finally:
        monkeypatch.undo()
    assert calls == [(1, n, n)] and linalg.subspace_matrices == 1
    U0, S0, _ = torch.linalg.svd(R[0])
    assert torch.equal(U[0], U0[:, :k]) and torch.equal(S[0], S0[:k])
    _check(R[1], (U[1], S[1], Vh[1]), k, slow)


@pytest.mark.parametrize("last,resid,want", [
    (None, 1e-3, False),                  # no rate yet
    ((5, 1e-3), 1e-3, True),              # did not fall
    ((5, 1e-3), float("nan"), True),
    ((5, 1e-2), 1e-3, False),             # 1e-7 by step 30
    ((5, 1e-2), 5e-3, True),              # 1e-7 only by step ~88
    ((5, 1e-3), 0.0, True),               # exact: met, no rate
], ids=["first_test", "flat", "nan", "on_time", "too_slow", "zero"])
def test_beyond_cap(last, resid, want):
    """Each matrix of a batch on its own residual and rate: the second
    matrix, falling on time, is never beyond the cap."""
    if last is not None:
        last = (last[0], torch.tensor([last[1], 1e-2]))
    got = linalg._beyond_cap(10, torch.tensor([resid, 1e-3]), last, 1e-7,
                             40)
    assert got.tolist() == [want, False]


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_non_finite_input_raises_as_gesvd(bad):
    n, k = 96, 5
    R = torch.stack([_with_spectrum(n, _clustered(n, 10), 80 + i)
                     for i in range(2)])
    R[1, 3, 4] = bad
    linalg.subspace_matrices = 0
    with pytest.raises(torch.linalg.LinAlgError):
        svd_subspace(R, k)
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.svd(R)
    # the finite matrix converged before the other's gesvd raised
    assert linalg.subspace_matrices == 1


def test_the_route_is_a_counted_span_inside_svd(monkeypatch):
    """svd_top on the route: one ``factorization.qr`` and one
    ``factorization.svd`` a batch, each counting its matrices, and inside
    the latter ``factorization.svd_subspace`` counting those returned
    converged; a matrix that falls back is not counted there."""
    n, p, k = 80, 400, 6
    M = _tall(n, p, _clustered(n, 10), 90, (3,))
    monkeypatch.setattr(linalg, "subspace_route", lambda *a: True)
    with profile(activities=[ProfilerActivity.CPU]):
        timing.clear_spans()
        svd_top(M, k)
        routed = timing.spans()
        monkeypatch.setattr(linalg, "SUBSPACE_SVD_MAX_STEPS", 2)
        timing.clear_spans()
        svd_subspace(_with_spectrum(n, _flat_past(n, k), 91), k)
        capped = timing.spans()
    assert [(s[0], s[3], s[5]) for s in routed] == [
        ("factorization.svd_top", None, None), ("factorization.qr", 0, 3),
        ("factorization.svd", 0, 3), ("factorization.svd_subspace", 2, 3)]
    assert [(s[0], s[3], s[5]) for s in capped] == [
        ("factorization.svd", None, 1),
        ("factorization.svd_subspace", 0, 0)]


def test_the_cpu_keeps_the_qr_and_svd_route(monkeypatch):
    """A CPU tensor never takes the route: svd_top is QR + svd as
    before, whatever its side."""
    monkeypatch.setattr(linalg, "svd_subspace", None)
    M = _tall(600, 2500, np.logspace(2, -2, 600), 95).float()
    Q, R = torch.linalg.qr(M.mT)
    U2 = Q @ torch.linalg.svd(R)[0]
    assert torch.equal(svd_top(M, 10), U2[:, :10].mT)


def test_the_double_pass_shapes_keep_the_qr_route():
    """Off the route a p > 4n batch keeps QR, :func:`svd` of its R
    factors (K5 or gesvd on the card) and Q @ Ur: counted spans
    ``factorization.qr`` and ``factorization.svd``, none of the route."""
    n, p, k = 39, 400, 3
    M = _tall(n, p, np.logspace(1, -2, n), 96, (4,))
    Q, R = torch.linalg.qr(M.mT)
    want = (Q @ torch.linalg.svd(R)[0])[..., :k].mT
    with profile(activities=[ProfilerActivity.CPU]):
        timing.clear_spans()
        V = svd_top(M, k)
        spans = timing.spans()
    assert torch.equal(V, want)
    assert [(s[0], s[3], s[5]) for s in spans] == [
        ("factorization.svd_top", None, None), ("factorization.qr", 0, 4),
        ("factorization.svd", 0, 4)]


def _fixed_grams():
    g = torch.Generator().manual_seed(2222)
    X = torch.randn((2, 24, 40), generator=g, dtype=torch.float64)
    X = X * torch.logspace(0, -3, 40, dtype=torch.float64)
    return X @ X.mT


# what ops.annular._subspace_topk(_fixed_grams(), 3) returned when the
# iteration lived in ops/annular.py: the eigenvalues and two sums of each
# eigenvector (weights 1..24, absolute values), as float.hex
ANNULAR_E = ["0x1.b76083e19c515p+4", "0x1.0715652b4f3bdp+4",
             "0x1.995bd18dd31e9p+3", "0x1.fbe7d66013d53p+4",
             "0x1.06d452076fc45p+4", "0x1.880500c68391fp+3"]
ANNULAR_UW = ["0x1.31abc5b80fad8p+4", "0x1.96960a6bdd93ap+3",
              "0x1.1f73fd8bb2f57p+3", "-0x1.820d552a42934p+2",
              "0x1.140ef5bba07fcp+4", "0x1.5bf20ffc53342p+3"]
ANNULAR_UABS = ["0x1.0d6e0aa0e087ep+2", "0x1.eb72c4e44ff50p+1",
                "0x1.ed172bb52ef2dp+1", "0x1.f6d0bfe9447b0p+1",
                "0x1.f48b297c2e6c4p+1", "0x1.e897abcc85654p+1"]


def test_annular_subspace_topk_returns_what_it_returned():
    e, U, met = annular._subspace_topk(_fixed_grams(), 3)
    assert bool(met.all())
    w = torch.arange(1, 25, dtype=torch.float64)
    for got, want in ((e, ANNULAR_E), ((U * w[:, None]).sum(-2), ANNULAR_UW),
                      (U.abs().sum(-2), ANNULAR_UABS)):
        want = torch.tensor([float.fromhex(v) for v in want],
                            dtype=torch.float64).reshape(2, 3)
        torch.testing.assert_close(got, want, rtol=1e-13, atol=0)

"""K5's plain version (``ops.linalg.svd_jacobi_plain``, the batched
one-sided Jacobi SVD) against float64 ``torch.linalg.svd`` on the CPU, and
``ops.linalg.svd``'s route to K5.

The plain version computes in float64 and stops when every pair of columns
is orthogonal to float32's epsilon relative to their norms. So on float64
input its singular values agree with LAPACK's to about float64 rounding
where they are apart (the error is quadratic in the pairs'
non-orthogonality): held at SV_TOL of the largest. Where they repeat, a
cluster's values agree to that non-orthogonality itself: REPEAT_TOL.
Singular vectors are compared as projectors onto the top-k of each side,
k at a gap of the spectrum (PROJ_TOL). The product U S Vh rebuilds the
matrix to float64 rounding (REC_TOL); the long side's vectors are
orthonormal to the stopping rule's tolerance (ORTH_TOL), the short side's
(a product of rotations) to float64 rounding.
"""

import importlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vip_tpu_torch.ops import linalg
from vip_tpu_torch.ops.linalg import (JACOBI_MAX_SWEEPS, jacobi_route, svd,
                                      svd_jacobi, svd_jacobi_plain)

SV_TOL = 1e-10
REPEAT_TOL = 1e-6
PROJ_TOL = 1e-5
REC_TOL = 1e-12
ORTH_TOL = 1e-6

timing = importlib.import_module("vip_tpu_torch.config.timing")


def _with_spectrum(m, n, s, seed, batch=()):
    """(*batch, m, n) float64 matrices Q1 diag(s) Q2ᵀ, Q1 and Q2 random
    with orthonormal columns."""
    g = torch.Generator().manual_seed(seed)
    k = len(s)
    Q1 = torch.linalg.qr(torch.randn((*batch, m, k), generator=g,
                                     dtype=torch.float64))[0]
    Q2 = torch.linalg.qr(torch.randn((*batch, n, k), generator=g,
                                     dtype=torch.float64))[0]
    return (Q1 * torch.as_tensor(s, dtype=torch.float64)) @ Q2.mT


def _upper(n, s, seed, batch=()):
    """The upper-triangular R factor of an (8n, n) matrix of spectrum s:
    what the double pass's spectral QR hands the SVD."""
    return torch.linalg.qr(_with_spectrum(8 * n, n, s, seed, batch))[1]


def _decaying(k):
    return np.logspace(2, -2, k)


# (name, matrix maker, top-k compared): sides 1..64, tall and wide, one
# matrix and batches
CASES = [
    ("1x1", lambda b: _with_spectrum(1, 1, [3.0], 1, b), 1),
    ("2x2", lambda b: _with_spectrum(2, 2, [3.0, 0.5], 2, b), 1),
    ("39x39 upper", lambda b: _upper(39, _decaying(39), 3, b), 5),
    ("61x61", lambda b: _with_spectrum(61, 61, _decaying(61), 4, b), 5),
    ("64x64", lambda b: _with_spectrum(64, 64, _decaying(64), 5, b), 5),
    ("17x40", lambda b: _with_spectrum(17, 40, _decaying(17), 6, b), 5),
    ("40x17", lambda b: _with_spectrum(40, 17, _decaying(17), 7, b), 5),
]


def _check(A, U, S, Vh, info, k, sv_tol=SV_TOL):
    m, n = A.shape[-2:]
    ref = torch.linalg.svd(A, full_matrices=False)
    assert U.shape == ref.U.shape and S.shape == ref.S.shape \
        and Vh.shape == ref.Vh.shape
    assert bool((S[..., :-1] >= S[..., 1:]).all())
    top = ref.S[..., :1].clamp(min=1e-300)
    assert float(((S - ref.S).abs() / top).max()) <= sv_tol
    for X, Xr in ((U[..., :k], ref.U[..., :k]),
                  (Vh[..., :k, :].mT, ref.Vh[..., :k, :].mT)):
        assert float((X @ X.mT - Xr @ Xr.mT).abs().max()) <= PROJ_TOL
    rec = (U * S[..., None, :]) @ Vh
    assert float((rec - A).abs().max()) <= REC_TOL * max(
        float(A.abs().max()), 1e-300)
    eye = torch.eye(min(m, n), dtype=A.dtype)
    assert float((U.mT @ U - eye).abs().max()) <= ORTH_TOL
    assert float((Vh @ Vh.mT - eye).abs().max()) <= ORTH_TOL
    assert info.shape == A.shape[:-2]
    assert bool(((info >= 1) & (info <= JACOBI_MAX_SWEEPS)).all())


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)],
                         ids=["one", "batch3", "batch2x2"])
@pytest.mark.parametrize("name,make,k", CASES, ids=[c[0] for c in CASES])
def test_plain_against_float64_svd(name, make, k, batch):
    A = make(batch)
    U, S, Vh, info = svd_jacobi_plain(A, with_info=True)
    _check(A, U, S, Vh, info, k)


# rank-deficient matrices, the zero matrix and repeated singular values
HARD = [
    ("rank3 10x8", lambda: _with_spectrum(10, 8, [9.0, 4.0, 1.0], 11), 3,
     SV_TOL),
    ("rank5 39x39 upper", lambda: torch.linalg.qr(
        _with_spectrum(312, 39, _decaying(5), 12))[1], 5, SV_TOL),
    ("rank1 17x40", lambda: _with_spectrum(17, 40, [2.0], 13), 1, SV_TOL),
    ("zero 5x3", lambda: torch.zeros((5, 3), dtype=torch.float64), 0,
     SV_TOL),
    ("zero 3x5", lambda: torch.zeros((3, 5), dtype=torch.float64), 0,
     SV_TOL),
    ("zero 39x39", lambda: torch.zeros((39, 39), dtype=torch.float64), 0,
     SV_TOL),
    ("zero column 6x4", lambda: torch.cat(
        [_with_spectrum(6, 3, [3.0, 2.0, 1.0], 14),
         torch.zeros((6, 1), dtype=torch.float64)], 1), 3, SV_TOL),
    ("repeated 39x39", lambda: _with_spectrum(
        39, 39, [5.0] * 4 + [2.0] * 3 + list(np.linspace(1.0, 0.1, 32)),
        15), 4, REPEAT_TOL),
    ("repeated 64x20", lambda: _with_spectrum(64, 20, [1.0] * 20, 16), 20,
     REPEAT_TOL),
]


@pytest.mark.parametrize("name,make,k,sv_tol", HARD,
                         ids=[c[0] for c in HARD])
def test_plain_hard_cases(name, make, k, sv_tol):
    """Zero singular values get orthonormal completions; a top-k at the
    edge of a cluster (or of the rank) is still a well-defined subspace."""
    A = make()
    U, S, Vh, info = svd_jacobi_plain(A, with_info=True)
    _check(A, U, S, Vh, info, k, sv_tol)
    if not bool(A.any()):
        assert bool((S == 0).all()) and int(info) == 1


def test_plain_in_float32():
    """float32 in, float32 out, within float32 rounding of float64."""
    A = _upper(39, _decaying(39), 21, (10,))
    U, S, Vh, info = svd_jacobi_plain(A.float(), with_info=True)
    assert U.dtype == S.dtype == Vh.dtype == torch.float32
    ref = torch.linalg.svd(A.float().double(), full_matrices=False)
    assert float(((S.double() - ref.S).abs() / ref.S[..., :1]).max()) <= 1e-6
    rec = (U.double() * S.double()[..., None, :]) @ Vh.double()
    assert float((rec - A).abs().max() / A.abs().max()) <= 1e-5
    assert bool((info >= 1).all())


def test_plain_reports_no_convergence(monkeypatch):
    """A matrix still rotating at the sweep cap reads -1."""
    monkeypatch.setattr(linalg, "JACOBI_MAX_SWEEPS", 1)
    A = _with_spectrum(8, 8, _decaying(8), 22, (2,))
    assert bool((svd_jacobi_plain(A, with_info=True)[3] == -1).all())


@pytest.mark.parametrize("K", [2, 4, 6, 40, 64])
def test_round_robin_covers_every_pair_once(K):
    steps = linalg._round_robin(K)
    assert len(steps) == K - 1
    seen = []
    for pairs in steps:
        cols = [c for p in pairs for c in p]
        assert len(pairs) == K // 2 and sorted(cols) == list(range(K))
        seen += [tuple(sorted(p)) for p in pairs]
    assert sorted(seen) == [(i, j) for i in range(K)
                            for j in range(i + 1, K)]


@pytest.mark.parametrize("shape,dtype", [
    ((39, 39), torch.float32), ((100, 39, 39), torch.float32),
    ((17, 40), torch.float32), ((9, 5), torch.float64),
    ((70, 70), torch.float32)], ids=["39", "100x39", "17x40", "f64", "70"])
def test_svd_on_the_cpu_is_torch_linalg_svd(shape, dtype):
    """CPU tensors keep ``torch.linalg.svd``: the same bits, no launch."""
    A = torch.randn(shape, dtype=dtype, generator=torch.Generator()
                    .manual_seed(3))
    linalg.jacobi_launches = 0
    for got, ref in zip(svd(A), torch.linalg.svd(A, full_matrices=False)):
        assert torch.equal(got, ref)
    assert linalg.jacobi_launches == 0


def _like(shape, dtype=torch.float32, device="cuda"):
    """What the route reads of a tensor, without a card."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 ndim=len(shape), shape=torch.Size(shape))


@pytest.mark.parametrize("shape,dtype,device,full,want", [
    ((39, 39), torch.float32, "cuda", False, True),
    ((100, 39, 39), torch.float32, "cuda", False, True),
    ((2, 3, 64, 64), torch.float32, "cuda", False, True),
    ((1, 1), torch.float32, "cuda", False, True),
    ((17, 40), torch.float32, "cuda", False, True),
    ((65, 65), torch.float32, "cuda", False, False),
    ((39, 65), torch.float32, "cuda", False, False),
    ((65, 1), torch.float32, "cuda", False, False),
    ((0, 5), torch.float32, "cuda", False, False),
    ((39,), torch.float32, "cuda", False, False),
    ((39, 39), torch.float64, "cuda", False, False),
    ((39, 39), torch.float16, "cuda", False, False),
    ((39, 39), torch.float32, "cpu", False, False),
    ((39, 39), torch.float32, "cuda", True, False),
], ids=["39", "100x39", "batch64", "1x1", "17x40", "65", "39x65", "65x1",
        "empty", "1d", "float64", "float16", "cpu", "full_matrices"])
def test_jacobi_route(shape, dtype, device, full, want):
    assert jacobi_route(_like(shape, dtype, device), full) is want


def test_svd_jacobi_on_the_cpu_is_the_plain_version():
    A = _upper(39, _decaying(39), 23, (4,)).float()
    linalg.jacobi_launches = 0
    for got, ref in zip(svd_jacobi(A, with_info=True),
                        svd_jacobi_plain(A, with_info=True)):
        assert torch.equal(got, ref)
    assert linalg.jacobi_launches == 0


def test_the_route_is_a_counted_span_inside_svd(monkeypatch):
    """Where the route engages, ``factorization.svd_jacobi`` opens inside
    ``factorization.svd`` and counts the matrices factored (here on the
    CPU, the route forced, so the plain version runs)."""
    A = _upper(39, _decaying(39), 24, (5, 2)).float()
    with profile(activities=[ProfilerActivity.CPU]):
        timing.clear_spans()
        svd(A)
        plain = timing.spans()
        monkeypatch.setattr(linalg, "jacobi_route", lambda *a, **k: True)
        timing.clear_spans()
        svd(A)
        routed = timing.spans()
    assert [s[0] for s in plain] == ["factorization.svd"]
    assert [(s[0], s[3], s[5]) for s in routed] == [
        ("factorization.svd", None, 10), ("factorization.svd_jacobi", 0, 10)]

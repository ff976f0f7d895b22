"""The port's NEGFC figures of merit (``fm.negfc_fmerit``) against
vip_tpu, on the CPU at float64.

- ``chisquare`` with the merits 'sum', 'stddev' and 'hessian' (mu_sigma
  None) and with a (mu, sigma) tuple, with frame weights and with a
  transmission table: 1e-10 relative (the same float64 reductions; the
  port injects on the cube's device by one indexed subtract, vip_tpu on
  the host frame by frame).
- ``hessian``: 1e-12.
- ``get_values_optimize`` and ``get_mu_and_sigma`` with the algos
  ``pca_annulus``, ``pca_annular`` and ``pca``, with and without the
  companion removed first (``f_guess``): 1e-9 of max(|ref|, 1e-3) (the
  annular PCA's per-frame SVDs agree to ~1e-12).
- ``get_mu_and_sigma`` with the high-pass filter of ``algo_options``
  (``hp_filter`` and ``hp_kernel``, three modes): 1e-9 as above.
- what is not ported raises: 4-d cubes (slice 7).
"""

import numpy as np
import pytest
import threadpoolctl

import vip_tpu_torch
import vip_tpu.fm as jfm
import vip_tpu.psfsub as jps
import vip_tpu_torch.fm as tfm
import vip_tpu_torch.psfsub as tps
from test_torch_negfc_model import FLUX, FWHM, R, THETA, negfc_data

TOL = 1e-10
ALGO_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread for vip_tpu's LAPACK calls (see
    tests/test_torch_annular.py)."""
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def data():
    return negfc_data()


MERITS = {
    "sum": dict(mu_sigma=None, fmerit="sum"),
    "stddev": dict(mu_sigma=None, fmerit="stddev"),
    "hessian": dict(mu_sigma=None, fmerit="hessian"),
    "mu_sigma": dict(mu_sigma=(0.001, 0.05)),
    "weights": dict(mu_sigma=(0.001, 0.05),
                    weights=np.linspace(0.8, 1.2, 10)),
    "transmission": dict(transmission=np.array([[0.0, 6.0, 30.0],
                                                [0.2, 0.7, 1.0]])),
    "cube_ref": dict(cube_ref="ref", scaling="temp-mean"),
}


@pytest.mark.parametrize("merit", list(MERITS))
def test_chisquare(data, merit):
    cube, angles, psfn, cube_ref = data
    kw = dict(MERITS[merit])
    if kw.get("cube_ref") == "ref":
        kw["cube_ref"] = cube_ref
    p = (R + 0.3, THETA - 1.0, FLUX * 1.1)
    ref = jfm.chisquare(p, cube, angles, psfn, FWHM, 4, 1, (R, THETA), 3,
                        **kw)
    got = tfm.chisquare(p, cube, angles, psfn, FWHM, 4, 1, (R, THETA), 3,
                        **kw)
    assert abs(got - ref) <= TOL * abs(ref)


def test_chisquare_force_rpa(data):
    cube, angles, psfn, _ = data
    ref = jfm.chisquare((FLUX * 0.9,), cube, angles, psfn, FWHM, 4, 1,
                        (R, THETA), 3, force_rPA=True)
    got = tfm.chisquare((FLUX * 0.9,), cube, angles, psfn, FWHM, 4, 1,
                        (R, THETA), 3, force_rPA=True)
    assert abs(got - ref) <= TOL * abs(ref)


def test_hessian():
    frame = np.random.default_rng(5).standard_normal((9, 11))
    ref = jfm.hessian(frame)
    got = tfm.hessian(frame)
    assert got.shape == ref.shape == (2, 2, 9, 11)
    assert np.max(np.abs(got - ref)) <= 1e-12


ALGOS = {"pca_annulus": (jps.pca_annulus, tps.pca_annulus),
         "pca_annular": (jps.pca_annular, tps.pca_annular),
         "pca": (jps.pca, tps.pca)}


def _rel(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-3)


@pytest.mark.parametrize("algo", list(ALGOS))
def test_get_values_optimize(data, algo):
    cube, angles, psfn, _ = data
    ja, ta = ALGOS[algo]
    ref, ref_frame = jfm.get_values_optimize(
        cube, angles, 3, 4, 1, FWHM, R, THETA, algo=ja, full_output=True)
    got, frame = tfm.get_values_optimize(
        cube, angles, 3, 4, 1, FWHM, R, THETA, algo=ta, full_output=True)
    assert got.size >= 10
    assert _rel(got, ref) <= ALGO_TOL
    assert _rel(frame, ref_frame) <= ALGO_TOL


@pytest.mark.parametrize("f_guess", [None, FLUX])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_get_mu_and_sigma(data, algo, f_guess):
    cube, angles, psfn, _ = data
    ja, ta = ALGOS[algo]
    kw = dict(f_guess=f_guess, psfn=psfn if f_guess else None)
    ref = jfm.get_mu_and_sigma(cube, angles, 3, 4, 1, FWHM, R, THETA,
                               algo=ja, **kw)
    got = tfm.get_mu_and_sigma(cube, angles, 3, 4, 1, FWHM, R, THETA,
                               algo=ta, **kw)
    assert abs(got[0] - ref[0]) <= ALGO_TOL * max(abs(ref[1]), 1e-3)
    assert abs(got[1] - ref[1]) <= ALGO_TOL * abs(ref[1])


def test_get_mu_and_sigma_wedge(data):
    cube, angles, psfn, _ = data
    for wedge in ((200, 100), (10, 140)):
        ref = jfm.get_mu_and_sigma(cube, angles, 3, 4, 1, FWHM, R, THETA,
                                   wedge=wedge)
        got = tfm.get_mu_and_sigma(cube, angles, 3, 4, 1, FWHM, R, THETA,
                                   wedge=wedge)
        assert np.allclose(got, ref, rtol=ALGO_TOL, atol=0)


@pytest.mark.parametrize("hp", [("median-subt", 5), ("gauss-subt", 3),
                                ("laplacian-conv", 3)],
                         ids=lambda hp: hp[0])
def test_get_mu_and_sigma_high_pass(data, hp):
    cube, angles, psfn, _ = data
    opts = {"hp_filter": hp[0], "hp_kernel": hp[1]}
    ref = jfm.get_mu_and_sigma(cube, angles, 3, 4, 1, FWHM, R, THETA,
                               f_guess=FLUX, psfn=psfn,
                               algo_options=dict(opts))
    got = tfm.get_mu_and_sigma(cube, angles, 3, 4, 1, FWHM, R, THETA,
                               f_guess=FLUX, psfn=psfn,
                               algo_options=dict(opts))
    assert abs(got[0] - ref[0]) <= ALGO_TOL * max(abs(ref[1]), 1e-3)
    assert abs(got[1] - ref[1]) <= ALGO_TOL * abs(ref[1])


def test_what_is_not_ported_raises(data):
    cube, angles, psfn, _ = data
    with pytest.raises(TypeError, match="not recognized"):
        tfm.get_mu_and_sigma(cube, angles, 3, 4, 1, FWHM, R, THETA,
                             algo_options={"hp_filter": "median",
                                           "hp_kernel": 3})
    cube4 = np.stack([cube, cube])
    with pytest.raises(NotImplementedError, match="slice 7"):
        tfm.chisquare((R, THETA, FLUX), cube4, angles, np.stack([psfn] * 2),
                      FWHM, 4, 1, (R, THETA), 3)
    with pytest.raises(NotImplementedError, match="slice 7"):
        tfm.get_mu_and_sigma(cube4, angles, 3, 4, 1, FWHM, R, THETA)

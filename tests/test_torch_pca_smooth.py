"""``psfsub.pca(smooth=)`` and ``psfsub.randomized_svd_gpu`` of the port
against vip_tpu, on the CPU at float64.

- ``smooth`` through each branch of ``pca``: the 3-d ADI frame (with and
  without ``mask_center_px``, with ``source_xy``) is convolved with a
  Gaussian of FWHM ``smooth`` before the central mask; a grid ``ncomp``,
  ``batch`` and 4-d cubes (per channel, single and double ADI+mSDI pass)
  ignore it, as in vip_tpu. 1e-10 of max(|ref|, 1).
- ``randomized_svd_gpu`` on a matrix with a decaying spectrum (wide and
  tall, ``n_iter="auto"`` both ways): the singular values within 1e-8
  relative, the rank-k projectors within 1e-6 (the Gaussian sketches
  differ: threefry against a ``torch.Generator``).
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch
import vip_tpu.psfsub as jps
import vip_tpu_torch.psfsub as tps
from conftest import make_adi_cube

TOL = 1e-10
SV_RTOL, PROJ_TOL = 1e-8, 1e-6

torch.set_num_threads(1)


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
def small():
    return make_adi_cube(n=20, size=32)


def _err(got, ref):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("kw", [
    dict(ncomp=3), dict(ncomp=3, mask_center_px=4),
    dict(ncomp=2, source_xy=(20, 16), delta_rot=0.2, fwhm=4,
         min_frames_pca=2)], ids=["adi", "mask", "source_xy"])
def test_smooth_of_the_final_frame(small, kw):
    cube, angles = small
    ref = jps.pca(cube.copy(), angles, smooth=2.0, verbose=False, **kw)
    got = tps.pca(cube.copy(), angles, smooth=2.0, verbose=False, **kw)
    assert _err(got, ref) <= TOL
    plain = tps.pca(cube.copy(), angles, verbose=False, **kw)
    assert _err(got, plain) > 1e-3


def test_smooth_ignored_by_the_grid(small):
    cube, angles = small
    kw = dict(ncomp=(1, 3), verbose=False)
    ref = jps.pca(cube.copy(), angles, smooth=2.0, **kw)
    got = tps.pca(cube.copy(), angles, smooth=2.0, **kw)
    assert _err(got, ref) <= TOL
    assert _err(got, tps.pca(cube.copy(), angles, **kw)) == 0


def test_smooth_ignored_by_batch(small):
    cube, angles = small
    kw = dict(ncomp=2, batch=10, verbose=False)
    ref = jps.pca(cube.copy(), angles, smooth=2.0, **kw)
    got = tps.pca(cube.copy(), angles, smooth=2.0, **kw)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=2), dict(ncomp=2, adimsdi="single"),
    dict(ncomp=(1, 2), adimsdi="double")], ids=["channels", "single",
                                                 "double"])
def test_smooth_ignored_by_4d_cubes(kw):
    rng = np.random.default_rng(4)
    cube = rng.standard_normal((3, 8, 24, 24))
    angles = np.linspace(0, 30, 8)
    if "adimsdi" in kw:
        kw = dict(kw, scale_list=np.array([1.0, 1.05, 1.1]))
    ref = jps.pca(cube.copy(), angles, smooth=2.0, verbose=False, **kw)
    got = tps.pca(cube.copy(), angles, smooth=2.0, verbose=False, **kw)
    assert _err(got, ref) <= TOL
    assert _err(got, tps.pca(cube.copy(), angles, verbose=False,
                             **kw)) == 0


def _decaying(n, p, seed=0):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((n, min(n, p))))[0]
    V = np.linalg.qr(rng.standard_normal((p, min(n, p))))[0]
    s = 10.0 ** (-np.arange(min(n, p)) / 4)
    return (U * s) @ V.T


@pytest.mark.parametrize("shape,k", (((60, 400), 10), ((300, 40), 3)))
def test_randomized_svd_gpu(shape, k):
    M = _decaying(*shape)
    U, S, Vh = (np.asarray(a) for a in jps.randomized_svd_gpu(
        M, k, random_state=3))
    u, s, vh = (a.numpy() for a in tps.randomized_svd_gpu(M, k,
                                                          random_state=3))
    assert u.shape == U.shape and vh.shape == Vh.shape
    np.testing.assert_allclose(s, S, rtol=SV_RTOL, atol=0)
    np.testing.assert_allclose(vh.T @ vh, Vh.T @ Vh, atol=PROJ_TOL)
    np.testing.assert_allclose(u @ u.T, U @ U.T, atol=PROJ_TOL)
    # the same seed gives the same draws
    again = tps.randomized_svd_gpu(M, k, random_state=3)[1].numpy()
    np.testing.assert_array_equal(again, s)

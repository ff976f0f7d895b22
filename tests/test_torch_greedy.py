"""Port's greedy algorithms (``greedy.ipca``, ``inmf``, ``iroll``)
against vip_tpu on the CPU at float64, in the modes tests/test_greedy.py
covers.

Every output at 1e-9 of max(|ref|, 1): the same float64 PCA, NMF and
roll subtractions, the same STIM thresholds, and the same signal masks
rotated by OpenCV's bilinear ``warpAffine`` (the port computes it
itself). 'Juillard23' leaves out ``sig_images``: its mask thresholds a
normalized STIM map at 0 where the map is rounding noise (~1e-17), in
both packages, so pixels flip with the order of a sum.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

from conftest import make_adi_cube
import vip_tpu.greedy as jgr
import vip_tpu_torch.greedy as tgr

torch.set_num_threads(1)

TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _check(got, ref, skip=()):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if i in skip:
            continue
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() / max(np.abs(r).max(), 1.0) \
            <= TOL, f"output {i}"


@pytest.fixture(scope="module")
def cube_angles():
    return make_adi_cube(n=15, size=51)


@pytest.mark.parametrize("kw", [
    dict(ncomp=3, nit=3, thr=0.5),
    dict(ncomp=3, nit=2, mode="Christiaens24", thr=0.5),
    dict(ncomp=3, nit=3, thr=0.5, smooth_ker=1.0, full_output=True),
    dict(ncomp=2, nit=3, thr=0.5, thr_mode="other", mask_center_px=4,
         full_output=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_ipca_vs_vip_tpu(cube_angles, kw):
    cube, angles = cube_angles
    ref = jgr.ipca(cube=cube.copy(), angle_list=angles, verbose=False, **kw)
    got = tgr.ipca(cube=cube.copy(), angle_list=angles, verbose=False, **kw)
    _check(got, ref)


def test_ipca_juillard23_vs_vip_tpu():
    cube, angles = make_adi_cube(n=16, size=50, rot_amp=70.0)
    kw = dict(ncomp=3, mode="Juillard23", nit=2, ncomp_start=1,
              verbose=False)
    ref = jgr.ipca(cube, angles, full_output=True, **kw)
    got = tgr.ipca(cube, angles, full_output=True, **kw)
    assert got[1].shape[0] == 3 * 2
    _check(got, ref, skip=(2,))
    _check(tgr.ipca(cube, angles, **kw), jgr.ipca(cube, angles, **kw))


@pytest.mark.parametrize("kw", [
    dict(ncomp=3, nit=2, thr=0.5, max_iter=100, handle_neg="subtr_min"),
    dict(ncomp=3, nit=2, mode="Pairet18", max_iter=50, smooth_ker=None,
         full_output=True),
    dict(ncomp=3, nit=2, mode="Pairet21", max_iter=50, smooth_ker=None,
         full_output=True),
    dict(ncomp=3, nit=2, mode="Christiaens21", max_iter=50,
         smooth_ker=None),
    dict(ncomp=3, nit=2, mode="other", max_iter=50, smooth_ker=None),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_inmf_vs_vip_tpu(cube_angles, kw):
    cube, angles = cube_angles
    cube = cube - cube.min() + 1.0
    ref = jgr.inmf(cube=cube, angle_list=angles, verbose=False, **kw)
    got = tgr.inmf(cube=cube, angle_list=angles, verbose=False, **kw)
    _check(got, ref)


def test_inmf_ncomp_list_too_long(cube_angles):
    cube, angles = cube_angles
    with pytest.raises(ValueError):
        tgr.inmf(cube=cube - cube.min() + 1.0, angle_list=angles,
                 ncomp=(1, 2, 3), verbose=False)


@pytest.mark.parametrize("kw", [
    dict(mode="individual", nit=2, thr=0.5, full_output=True),
    dict(mode="individual", nit=1, thr=0.5, thr_mode="other"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_iroll_vs_vip_tpu(kw):
    cube, _ = make_adi_cube(n=16, size=51)
    angles = np.array([0.0] * 8 + [25.0] * 8)
    ref = jgr.iroll(cube=cube.copy(), angle_list=angles, verbose=False, **kw)
    got = tgr.iroll(cube=cube.copy(), angle_list=angles, verbose=False, **kw)
    _check(got, ref)

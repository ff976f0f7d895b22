"""Port's ``psfsub.xloci`` against vip_tpu on the CPU at float64, and the
loci_adi golden (slow lane, as vip_tpu's, tests/test_golden.py:96).

- ``xloci`` for each metric (L1, L2, correlation, cosine) and each
  solver ('lstsq', 'nnls', 'lsq') on a small cube, at 1e-9 of
  max(|ref|, 1): the same libraries (the distances on the device, the
  percentile and the PA filter on the host), the same float64 solves.
  The box solver's FISTA runs until its KKT stop (up to 200k steps a
  segment on the correlated frames of ``make_adi_cube``), so its case
  takes white-noise frames, whose Grams are well conditioned.
- The pairwise distances against ``scipy.spatial.distance.cdist``.
- A 4-d cube (slice 7) meets vip_tpu (tests/test_torch_ifs_more.py
  holds the rest of the 4-d paths).
"""

import numpy as np
import pytest
import threadpoolctl
import torch
from scipy.spatial.distance import cdist

import vip_tpu_torch

from conftest import make_adi_cube
import vip_tpu.psfsub as jps
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.psfsub.loci import _METRIC_MAP, pairwise_distances
from test_torch_llsg import golden_ds, golden_frame  # noqa: F401

torch.set_num_threads(1)

TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _err(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("metric,solver,size", [
    ("manhattan", "lstsq", 41), ("euclidean", "lstsq", 41),
    ("correlation", "lstsq", 41), ("cosine", "nnls", 41),
    ("l1", "lsq", 25)])
def test_xloci_vs_vip_tpu(metric, solver, size):
    cube, angles = make_adi_cube(n=24, size=size)
    if solver == "lsq":
        cube = np.random.default_rng(6).standard_normal(cube.shape)
    args = dict(fwhm=4, asize=4, n_segments="auto", metric=metric,
                radius_int=4, dist_threshold=90, delta_rot=0.5,
                optim_scale_fact=2, solver=solver, tol=0.01, verbose=False)
    ref = jps.xloci(cube=cube.copy(), angle_list=angles, **args)
    got = tps.xloci(cube=cube.copy(), angle_list=angles, **args)
    assert _err(got, ref) <= TOL


def test_xloci_full_output_and_no_distance_filter():
    cube, angles = make_adi_cube(n=20, size=33)
    args = dict(fwhm=4, asize=4, n_segments=2, radius_int=6,
                dist_threshold=100, delta_rot=(0.1, 1), full_output=True,
                verbose=False)
    ref = jps.xloci(cube=cube.copy(), angle_list=angles, **args)
    got = tps.xloci(cube=cube.copy(), angle_list=angles, **args)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert _err(g, r) <= TOL


@pytest.mark.parametrize("metric", sorted(_METRIC_MAP))
def test_pairwise_distances_vs_scipy(metric):
    v = np.random.default_rng(5).standard_normal((15, 70))
    got = pairwise_distances(torch.as_tensor(v), metric).numpy()
    np.testing.assert_allclose(got, cdist(v, v, metric=_METRIC_MAP[metric]),
                               rtol=1e-12, atol=1e-12)


def test_xloci_4d_waits_for_slice_7():
    """Slice 7 ported the 4-d cube: 'skipadi' (channel by channel) and
    'double' against vip_tpu."""
    cube, angles = make_adi_cube(n=8, size=25)
    cube4 = np.stack([cube, cube[::-1].copy(), cube])
    for adimsdi in ("skipadi", "double"):
        kw = dict(cube=cube4, angle_list=angles,
                  scale_list=np.array([1.3, 1.15, 1.0]), adimsdi=adimsdi,
                  asize=5, radius_int=3, delta_sep=0.1, delta_rot=0.3,
                  n_segments=1, verbose=False)
        assert _err(tps.xloci(**kw), jps.xloci(**kw)) <= TOL


@pytest.mark.slow
def test_golden_loci(golden_ds):  # noqa: F811
    golden_frame(golden_ds, "loci_adi")

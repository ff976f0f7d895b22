"""Port's public ``psfsub.pca`` against vip_tpu and the committed goldens,
on the CPU at float64.

- Port against vip_tpu on a small synthetic cube, for ADI, RDI and ARDI,
  every ``scaling``, ``mask_center_px`` and the ``source_xy``/``delta_rot``
  branch. The lapack SVD is the same float64 factorization in another
  library: 1e-10 of max(|ref|, 1).
- The goldens pca_adi, pca_linalg_adi and pca_drot_adi (VIP's own frames
  on the NACO replica, tests/golden/) at ≤1e-5 max abs, the contract of
  tests/test_golden.py:28, with vip_tpu's ``detection`` as the 3-px oracle
  on the port's frame.
- ``convert.params_from_numpy`` round trips.
"""

import os

import numpy as np
import pytest
import torch

from conftest import make_adi_cube
from gen_golden import (GOLDEN_DIR, SNR_THRESH, input_checksum,
                        input_dataset_cached, psfsub_configs)
import vip_tpu.psfsub as jps
from vip_tpu.config import Scaling as JScaling, SvdMode as JSvdMode
from vip_tpu_torch import convert
from vip_tpu_torch.config import Scaling, SvdMode
import vip_tpu_torch.psfsub as tps

torch.set_num_threads(1)

TOL = 1e-10
FRAME_TOL = 1e-5    # tests/test_golden.py:28
DELTAPIX = 3        # tests/test_golden.py:29


@pytest.fixture(scope="module")
def small():
    cube, angles = make_adi_cube(n=24, size=32)
    ref = make_adi_cube(n=12, size=32, rng=np.random.default_rng(9))[0]
    return cube, angles, ref


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("scaling", [None, "temp-mean", "spat-mean",
                                     "temp-standard", "spat-standard"])
def test_pca_adi_every_scaling_vs_vip_tpu(small, scaling):
    cube, angles, _ = small
    kw = dict(ncomp=4, scaling=scaling, verbose=False)
    ref = jps.pca(cube.copy(), angles, **kw)
    got = tps.pca(cube.copy(), angles, **kw)
    assert got.dtype == torch.float64
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("strategy", ["RDI", "ARDI"])
def test_pca_rdi_ardi_vs_vip_tpu(small, strategy):
    cube, angles, cube_ref = small
    kw = dict(cube_ref=cube_ref, ref_strategy=strategy, ncomp=3,
              verbose=False)
    assert _err(tps.pca(cube.copy(), angles, **kw),
                jps.pca(cube.copy(), angles, **kw)) <= TOL


def test_pca_mask_center_full_output_vs_vip_tpu(small):
    cube, angles, _ = small
    kw = dict(ncomp=3, mask_center_px=5, svd_mode="eigen", full_output=True,
              verbose=False)
    ref = jps.pca(cube.copy(), angles, **kw)
    got = tps.pca(cube.copy(), angles, **kw)
    assert len(got) == len(ref) == 5
    # frame, reconstruction, residuals, derotated residuals (the PCs match
    # up to sign); eigen: 1e-8, see test_torch_pipeline.py
    for i in (0, 2, 3, 4):
        assert _err(got[i], ref[i]) <= 1e-8


def test_pca_source_xy_delta_rot_vs_vip_tpu(small):
    cube, angles, cube_ref = small
    for extra in ({}, dict(cube_ref=cube_ref)):
        kw = dict(ncomp=3, source_xy=(26, 16), delta_rot=0.5, fwhm=4,
                  full_output=True, verbose=False, **extra)
        ref = jps.pca(cube.copy(), angles, **kw)
        got = tps.pca(cube.copy(), angles, **kw)
        for g, r in zip(got, ref):
            assert _err(g, r) <= TOL


def test_pca_paths_still_to_port_raise(small):
    cube, angles, _ = small
    for kw in (dict(ncomp=(1, 2)), dict(ncomp=0.9), dict(left_eigv=True),
               dict(batch=10), dict(smooth=2)):
        with pytest.raises(NotImplementedError):
            tps.pca(cube, angles, verbose=False, **kw)
    with pytest.raises(NotImplementedError):
        tps.pca(cube[None], angles, verbose=False)


def test_params_from_numpy_round_trip(small):
    cube, angles, _ = small
    jp = jps.PCA_Params(cube=cube, angle_list=angles, ncomp=3,
                        svd_mode=JSvdMode.EIGEN, scaling=JScaling.TEMPMEAN,
                        verbose=False)
    tp = convert.params_from_numpy(jp, device="cpu", dtype=torch.float64)
    assert isinstance(tp, tps.PCA_Params)
    assert isinstance(tp.cube, torch.Tensor)
    np.testing.assert_array_equal(tp.cube.numpy(), cube)
    np.testing.assert_array_equal(tp.angle_list.numpy(), angles)
    assert tp.svd_mode is SvdMode.EIGEN and tp.scaling is Scaling.TEMPMEAN
    assert tp.ncomp == 3 and tp.verbose is False and tp.fwhm == jp.fwhm
    ref = jps.pca(algo_params=jp)
    got = tps.pca(algo_params=tp)
    assert _err(got, ref) <= 1e-8
    assert _err(got, tps.pca(cube, angles, ncomp=3, svd_mode="eigen",
                             scaling="temp-mean", verbose=False)) == 0


# ---------------------------------------------------------------------------
# committed goldens (VIP's own frames on the NACO replica)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden_ds():
    if not os.path.exists(os.path.join(GOLDEN_DIR, "meta.npz")):
        pytest.skip("golden snapshots not generated")
    ds = input_dataset_cached()
    meta = np.load(os.path.join(GOLDEN_DIR, "meta.npz"))
    assert input_checksum(ds) == bytes(meta["checksum"]).hex()
    ds["expected_yx"] = [tuple(meta["planet_yx"]), tuple(meta["injected_yx"])]
    return ds


def _golden_run(ds, name):
    for cname, fn, kwargs, _ in psfsub_configs(ds):
        if cname == name:
            assert fn == "pca"
            return tps.pca(cube=ds["cube"].copy(), angle_list=ds["angles"],
                           **kwargs)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["pca_adi", "pca_linalg_adi",
                                  "pca_drot_adi"])
def test_golden_frame(golden_ds, name):
    mine = _golden_run(golden_ds, name).numpy()
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    err = float(np.max(np.abs(mine - ref)))
    assert err <= FRAME_TOL, f"{name}: max abs err {err:.2e}"
    if name == "pca_adi":
        _check_detection(mine, golden_ds)


def _check_detection(frame, ds):
    """3-px detection oracle (tests/test_golden.py:62-82), with vip_tpu's
    detection run on the port's frame."""
    from vip_tpu.metrics import detection

    table = detection(frame, fwhm=ds["fwhm"], mode="lpeaks", bkg_sigma=5,
                      matched_filter=False, mask=True, snr_thresh=SNR_THRESH,
                      plot=False, debug=False, full_output=True,
                      verbose=False)
    yy = np.atleast_1d(np.asarray(table.y, dtype=float))
    xx = np.atleast_1d(np.asarray(table.x, dtype=float))
    for ey, ex in ds["expected_yx"]:
        assert any(abs(y - ey) <= DELTAPIX and abs(x - ex) <= DELTAPIX
                   for y, x in zip(yy, xx)), \
            f"companion at {(ey, ex)} not recovered: {list(zip(yy, xx))}"

"""Port's ``psfsub.llsg`` against vip_tpu on the CPU at float64, and the
llsg_adi golden.

- ``llsg`` for each ``low_rank_mode``, ``thresh_mode`` and
  ``auto_rank_mode``, with a reference library and several azimuth
  rotations, the same ``random_seed`` (both draw with numpy's
  RandomState), at 1e-9 of max(|ref|, 1); the 'brp' mode at 1e-5: its
  sketch is powered once through MᵀM, so the QR sees the float64
  rounding of both libraries' products scaled by the condition number.
- ``thresholding`` for each mode, exactly.
- The golden llsg_adi (VIP's own frame on the NACO replica) at ≤1e-5
  max abs (tests/test_golden.py:28), and the 3-px oracle: the port's own
  ``detection`` finds every planted companion that VIP's found.
  ``golden_ds``, ``check_detection`` and ``golden_frame`` serve the other
  slice-4 golden tests too.
"""

import os

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

from conftest import make_adi_cube
from gen_golden import (GOLDEN_DIR, SNR_THRESH, input_checksum,
                        input_dataset_cached, psfsub_configs)
import vip_tpu.psfsub as jps
import vip_tpu_torch.metrics as tmet
import vip_tpu_torch.psfsub as tps

torch.set_num_threads(1)

TOL = 1e-9
BRP_TOL = 1e-5
FRAME_TOL = 1e-5    # tests/test_golden.py:28
DELTAPIX = 3        # tests/test_golden.py:29


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode)."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0)


@pytest.fixture(scope="module")
def golden_ds():
    if not os.path.exists(os.path.join(GOLDEN_DIR, "meta.npz")):
        pytest.skip("golden snapshots not generated")
    ds = input_dataset_cached()
    meta = np.load(os.path.join(GOLDEN_DIR, "meta.npz"))
    assert input_checksum(ds) == bytes(meta["checksum"]).hex()
    ds["expected_yx"] = [tuple(meta["planet_yx"]), tuple(meta["injected_yx"])]
    return ds


def check_detection(frame, ds, name):
    """3-px detection oracle (tests/test_golden.py:59-76) with the port's
    own ``detection``: every planted companion that VIP's detection found
    on golden ``name`` (``{name}_detect.npy``) is found within 3 px."""
    table = tmet.detection(frame, fwhm=ds["fwhm"], mode="lpeaks",
                           bkg_sigma=5, matched_filter=False, mask=True,
                           snr_thresh=SNR_THRESH, plot=False, debug=False,
                           full_output=True, verbose=False)
    yy = np.atleast_1d(np.asarray(table.y, dtype=float))
    xx = np.atleast_1d(np.asarray(table.x, dtype=float))
    vip = np.load(os.path.join(GOLDEN_DIR, f"{name}_detect.npy"))

    def near(ys, xs, c):
        return any(abs(y - c[0]) <= DELTAPIX and abs(x - c[1]) <= DELTAPIX
                   for y, x in zip(ys, xs))

    found_by_vip = [c for c in ds["expected_yx"]
                    if near(vip[:, 0], vip[:, 1], c)]
    assert found_by_vip, f"{name}: VIP found no planted companion"
    for c in found_by_vip:
        assert near(yy, xx, c), \
            f"{name}: companion at {c} not recovered: {list(zip(yy, xx))}"


def golden_frame(ds, name):
    """The port's frame of golden ``name``, its error against VIP's golden
    frame, and the 3-px oracle."""
    for cname, fn, kwargs, _ in psfsub_configs(ds):
        if cname == name:
            frame = getattr(tps, fn)(cube=ds["cube"].copy(),
                                     angle_list=ds["angles"], **kwargs)
            break
    else:
        raise KeyError(name)
    frame = frame.numpy()
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    err = float(np.max(np.abs(frame - ref)))
    assert err <= FRAME_TOL, f"{name}: max abs err {err:.2e}"
    check_detection(frame, ds, name)


@pytest.fixture(scope="module")
def small():
    cube, angles = make_adi_cube(n=20, size=41)
    # the soft threshold is sqrt(MAD): scale the frames so that the sparse
    # term is not empty
    return 100 * cube, angles


@pytest.mark.parametrize("kw", [
    dict(),
    dict(thresh_mode="hard"),
    dict(thresh_mode="nng"),
    dict(thresh_mode="greater", thresh=3),
    dict(thresh_mode="less", thresh=-3),
    dict(auto_rank_mode="cevr", rank="auto"),
    dict(rank="auto", residuals_tol=0.3),
    dict(low_rank_ref=True),
    dict(azimuth_overlap=180, n_segments=2),
    dict(full_output=True),
    dict(low_rank_mode="brp"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_llsg_vs_vip_tpu(small, kw):
    cube, angles = small
    args = dict(fwhm=4, rank=5, thresh=1, max_iter=5, random_seed=10,
                verbose=False)
    args.update(kw)
    ref = jps.llsg(cube=cube.copy(), angle_list=angles, **args)
    got = tps.llsg(cube=cube.copy(), angle_list=angles, **args)
    tol = BRP_TOL if kw.get("low_rank_mode") == "brp" else TOL
    if kw.get("full_output"):
        assert len(got) == len(ref) == 6
        for g, r in zip(got[3:], ref[3:]):
            assert _err(g, r) <= tol
        for gl, rl in zip(got[:3], ref[:3]):
            for g, r in zip(gl, rl):
                assert _err(g, r) <= tol
    else:
        assert float(torch.abs(got).max()) > 0
        assert _err(got, ref) <= tol


@pytest.mark.parametrize("mode", ["soft", "hard", "nng", "greater", "less"])
def test_thresholding_vs_vip_tpu(mode):
    x = np.random.default_rng(4).standard_normal((7, 9))
    x[0, 0] = 0.5
    np.testing.assert_array_equal(tps.thresholding(x, 0.5, mode).numpy(),
                                  jps.thresholding(x, 0.5, mode))


def test_llsg_high_pass_waits_for_slice_8(small):
    """``high_pass`` (once waiting for slice 8's high-pass filters, ported
    with slice 6): the decomposition of the median-subtracted,
    'laplacian-conv' filtered cube, against vip_tpu at TOL."""
    cube, angles = small
    for kernel in (3, 5):
        args = dict(fwhm=4, rank=5, thresh=1, max_iter=5, random_seed=10,
                    high_pass=kernel, verbose=False)
        ref = jps.llsg(cube=cube.copy(), angle_list=angles, **args)
        got = tps.llsg(cube=cube.copy(), angle_list=angles, **args)
        assert float(torch.abs(got).max()) > 0
        assert _err(got, ref) <= TOL


def test_golden_llsg(golden_ds):
    golden_frame(golden_ds, "llsg_adi")

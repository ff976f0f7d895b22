"""Port's ``psfsub.median_sub`` against vip_tpu and the committed goldens,
on the CPU at float64, and the companion search end to end.

- median-ADI and median-RDI, full-frame and annular, against vip_tpu at
  1e-10 of max(|ref|, 1): the same float64 medians, sums and FFT
  rotations in another library. The annular medians are gathered per
  frame library (``_library_medians``), not vip_tpu's (n, n, p) masked
  tensor: same numbers, held here, with the block size forced small too.
- The goldens medsub_adi and medsub_ann_adi (VIP's own frames on the NACO
  replica) at ≤1e-5 max abs (tests/test_golden.py:28) with the port's own
  ``detection`` as the 3-px oracle.
- A synthetic cube with a planted companion through the port's
  ``median_sub`` → ``snrmap`` → ``detection``, against the same steps in
  vip_tpu.
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
import vip_tpu.metrics as jmet
import vip_tpu.psfsub as jps
from vip_tpu_torch import convert
import vip_tpu_torch.metrics as tmet
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.psfsub import medsub

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One BLAS thread for vip_tpu's host calls beside other test workers
    (see tests/test_torch_annular.py)."""
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


TOL = 1e-10
FRAME_TOL = 1e-5    # tests/test_golden.py:28
DELTAPIX = 3        # tests/test_golden.py:29


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    return np.nanmax(np.abs(got - ref)) / max(np.nanmax(np.abs(ref)), 1.0)


@pytest.fixture(scope="module")
def small():
    cube, angles = make_adi_cube(n=24, size=32)
    ref = make_adi_cube(n=12, size=32, rng=np.random.default_rng(9))[0]
    return cube, angles, ref


@pytest.mark.parametrize("kw", [
    dict(mode="fullfr"),
    dict(mode="fullfr", collapse="mean"),
    dict(mode="annular"),
    dict(mode="annular", nframes=None),
    dict(mode="annular", nframes=6, delta_rot=0.5),
    dict(mode="annular", delta_rot=0),
    dict(mode="annular", radius_int=4, asize=3),
    dict(mode="fullfr", imlib="vip-fft-small"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_median_adi_vs_vip_tpu(small, kw):
    cube, angles, _ = small
    ref = jps.median_sub(cube.copy(), angles, verbose=False, **kw)
    got = tps.median_sub(cube.copy(), angles, verbose=False, **kw)
    assert got.dtype == torch.float64
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("collapse_ref", ["median", "mean", "median_sc",
                                          "mean_sc", "max"])
@pytest.mark.parametrize("mode", ["fullfr", "annular"])
def test_median_rdi_vs_vip_tpu(small, mode, collapse_ref):
    cube, angles, cube_ref = small
    kw = dict(mode=mode, cube_ref=cube_ref, collapse_ref=collapse_ref,
              verbose=False)
    assert _err(tps.median_sub(cube.copy(), angles, **kw),
                jps.median_sub(cube.copy(), angles, **kw)) <= TOL


def test_median_sub_full_output_and_nan_vs_vip_tpu(small):
    """(cube_out, cube_der, frame); a NaN pixel propagates through the
    median model (numpy.median) and the derotation's mask, as in vip_tpu."""
    cube, angles, _ = small
    cube = cube.copy()
    cube[3, 10, 12] = np.nan
    for mode in ("fullfr", "annular"):
        ref = jps.median_sub(cube.copy(), angles, mode=mode,
                             full_output=True, verbose=False)
        got = tps.median_sub(cube.copy(), angles, mode=mode,
                             full_output=True, verbose=False)
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            assert _err(g, r) <= TOL


def test_library_medians_in_blocks(small, monkeypatch):
    """Blocks of a few frames give the same residuals as one block."""
    cube, angles, _ = small
    whole = tps.median_sub(cube.copy(), angles, mode="annular",
                           nframes=None, verbose=False)
    monkeypatch.setattr(medsub, "_LIB_BLOCK_BYTES", 24 * 60 * 8 * 3)
    assert torch.equal(tps.median_sub(cube.copy(), angles, mode="annular",
                                      nframes=None, verbose=False), whole)


def test_median_sub_params_from_numpy(small):
    cube, angles, _ = small
    jp = jps.MEDIAN_SUB_Params(cube=cube, angle_list=angles, mode="annular",
                               asize=3, verbose=False)
    tp = convert.params_from_numpy(jp, device="cpu", dtype=torch.float64)
    assert isinstance(tp, tps.MEDIAN_SUB_Params)
    assert isinstance(tp.cube, torch.Tensor)
    np.testing.assert_array_equal(tp.angle_list.numpy(), angles)
    assert tp.mode == "annular" and tp.asize == 3 and tp.imlib == "vip-fft"
    assert _err(tps.median_sub(algo_params=tp),
                jps.median_sub(algo_params=jp)) <= TOL


def test_median_sub_4d_raises(small):
    """Slice 7 ported the 4-d cube: two channels at scales 1.2 and 1
    against vip_tpu (tests/test_torch_ifs_more.py holds the rest)."""
    cube, angles, _ = small
    cube4 = np.stack([cube, cube[::-1].copy()])
    for mode in ("fullfr", "annular"):
        kw = dict(scale_list=np.array([1.2, 1.0]), mode=mode, delta_sep=0.1,
                  radius_int=4, nframes=None, verbose=False)
        assert _err(tps.median_sub(cube4.copy(), angles, **kw),
                    jps.median_sub(cube4.copy(), angles, **kw)) <= TOL


# ---------------------------------------------------------------------------
# the companion search end to end
# ---------------------------------------------------------------------------
def _planted(n=30, size=64, sep=14.0, peak=2.0, fwhm=4.0, seed=3):
    """A synthetic ADI cube with one companion at (cy, cx + sep) after
    derotation: in frame i it sits at parallactic angle θ_i, (cy −
    sep·sin θ_i, cx + sep·cos θ_i) in (row, column)."""
    cube, angles = make_adi_cube(n=n, size=size, rng=np.random.default_rng(
        seed))
    c = size // 2
    yy, xx = np.mgrid[:size, :size]
    sig = fwhm / (2 * np.sqrt(2 * np.log(2)))
    for i, a in enumerate(np.deg2rad(angles)):
        py, px = c - sep * np.sin(a), c + sep * np.cos(a)
        cube[i] += peak * np.exp(-((yy - py) ** 2 + (xx - px) ** 2)
                                 / (2 * sig ** 2))
    return cube, angles, (c, c + sep)


def test_companion_search_end_to_end_vs_vip_tpu():
    cube, angles, (ey, ex) = _planted()
    frame_t = tps.median_sub(cube.copy(), angles, verbose=False)
    frame_j = jps.median_sub(cube.copy(), angles, verbose=False)
    assert _err(frame_t, frame_j) <= TOL
    smap_t = tmet.snrmap(frame_t, 4, verbose=False)
    smap_j = jmet.snrmap(np.asarray(frame_j), 4, verbose=False)
    assert _err(smap_t, smap_j) <= TOL
    kw = dict(fwhm=4, mode="lpeaks", bkg_sigma=3, snr_thresh=3, plot=False,
              verbose=False)
    yy_t, xx_t = tmet.detection(frame_t, **kw)
    yy_j, xx_j = jmet.detection(np.asarray(frame_j), **kw)
    np.testing.assert_allclose(yy_t, yy_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(xx_t, xx_j, rtol=0, atol=1e-8)
    assert any(abs(y - ey) <= DELTAPIX and abs(x - ex) <= DELTAPIX
               for y, x in zip(yy_t, xx_t)), (ey, ex, yy_t, xx_t)
    peak = np.unravel_index(int(torch.argmax(smap_t)), smap_t.shape)
    assert abs(peak[0] - ey) <= DELTAPIX and abs(peak[1] - ex) <= DELTAPIX


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


def _check_detection(frame, ds):
    """3-px detection oracle (tests/test_golden.py:59-76) with the port's
    own ``detection``."""
    table = tmet.detection(frame, fwhm=ds["fwhm"], mode="lpeaks",
                           bkg_sigma=5, matched_filter=False, mask=True,
                           snr_thresh=SNR_THRESH, plot=False, debug=False,
                           full_output=True, verbose=False)
    yy = np.atleast_1d(np.asarray(table.y, dtype=float))
    xx = np.atleast_1d(np.asarray(table.x, dtype=float))
    for ey, ex in ds["expected_yx"]:
        assert any(abs(y - ey) <= DELTAPIX and abs(x - ex) <= DELTAPIX
                   for y, x in zip(yy, xx)), \
            f"companion at {(ey, ex)} not recovered: {list(zip(yy, xx))}"


@pytest.mark.parametrize("name", ["medsub_adi", "medsub_ann_adi"])
def test_golden_frame(golden_ds, name):
    for cname, fn, kwargs, _ in psfsub_configs(golden_ds):
        if cname == name:
            assert fn == "median_sub"
            mine = tps.median_sub(cube=golden_ds["cube"].copy(),
                                  angle_list=golden_ds["angles"], **kwargs)
            break
    else:
        raise KeyError(name)
    mine = mine.numpy()
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    err = float(np.max(np.abs(mine - ref)))
    assert err <= FRAME_TOL, f"{name}: max abs err {err:.2e}"
    if name == "medsub_adi":
        _check_detection(mine, golden_ds)

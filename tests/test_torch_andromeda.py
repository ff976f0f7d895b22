"""The port's ANDROMEDA (``invprob.andromeda``, ``invprob.utils_andro``)
against vip_tpu, on the CPU at float64, and the goldens andro_adi and
androl1_adi.

- The utilities: ``robust_std``, ``idl_round`` and ``idl_where`` exactly;
  ``fitaffine`` (one fit, and a batch of fits against vip_tpu's fit of
  each row) and ``rofunc`` at 1e-12; ``subpixel_shift`` and the
  sub-pixel PSF bank ``calc_psf_shift_subpix`` at 1e-12.
- ``create_indices`` exactly; ``diff_images`` with each opt_method ('no',
  'total', 'lsq', 'l1') at 1e-10.
- ``andromeda_core`` (homogeneous and per-pixel variance), the full
  ``andromeda`` with 'lsq', 'l1' and 'total', ``normalize_snr`` and
  ``couronne_img``: 1e-8 of max|ref| (the same float64 arithmetic, summed
  in another order), on the 12x40² fixture of
  tests/test_invprob_andromeda.py.
- The goldens (VIP's own maps on the NACO replica, tests/test_golden.py):
  contrast and normalized S/N at ≤1e-5 max abs (FRAME_TOL), and the
  3-px oracle with the port's ``detection``. They run in tier 1: the
  port takes ~15 s a golden on one CPU thread.
"""

import importlib
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch
from gen_golden import (GOLDEN_DIR, SNR_THRESH, input_dataset_cached,
                        invprob_configs)
import vip_tpu_torch.metrics as tmet

ja = importlib.import_module("vip_tpu.invprob.andromeda")
ju = importlib.import_module("vip_tpu.invprob.utils_andro")
ta = importlib.import_module("vip_tpu_torch.invprob.andromeda")
tu = importlib.import_module("vip_tpu_torch.invprob.utils_andro")

torch.set_num_threads(1)

UTIL_TOL = 1e-12
DIFF_TOL = 1e-10
MAP_TOL = 1e-8
FRAME_TOL = 1e-5    # tests/test_golden.py:28
DELTAPIX = 3        # tests/test_golden.py:29


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


def andromeda_data():
    """The 12x40² cube of tests/test_invprob_andromeda.py: white noise
    with a bright companion at (y, x) = (+8, +3) turning with the angles,
    its angles and an 8x8 Gaussian PSF."""
    rng = np.random.default_rng(42)
    n, sz = 12, 40
    angs = np.linspace(-20, 20, n)
    cube = rng.normal(0, 1, (n, sz, sz))
    yy, xx = np.mgrid[:sz, :sz]
    for k, a in enumerate(angs):
        th = np.deg2rad(a)
        cy = sz / 2 - 0.5 + (8 * np.cos(th) - 3 * np.sin(th))
        cx = sz / 2 - 0.5 + (3 * np.cos(th) + 8 * np.sin(th))
        cube[k] += 20 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)
    psf = np.exp(-((yy - sz / 2) ** 2 + (xx - sz / 2) ** 2) / 3.0)
    psf = psf[sz // 2 - 4:sz // 2 + 4, sz // 2 - 4:sz // 2 + 4].copy()
    return cube, angs, psf


@pytest.fixture(scope="module")
def data():
    return andromeda_data()


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def test_utils():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 200)
    y = 2.5 * x + 0.3 + rng.normal(0, 0.1, 200)
    assert float(tu.robust_std(x)) == ju.robust_std(x)
    assert float(tu.robust_std(x[:199])) == ju.robust_std(x[:199])
    vals = rng.uniform(-3, 3, 50)
    vals[:4] = [0.5, -0.5, 1.5, -2.5]
    np.testing.assert_array_equal(tu.idl_round(vals), ju.idl_round(vals))
    np.testing.assert_array_equal(tu.idl_round(torch.from_numpy(vals)),
                                  ju.idl_round(vals))
    np.testing.assert_array_equal(tu.idl_where(vals > 1),
                                  ju.idl_where(vals > 1))
    for b in (2.4, 2.6):
        got, ref = tu.rofunc(x, y, b), ju.rofunc(x, y, b)
        assert abs(float(got[0]) - ref[0]) <= UTIL_TOL * np.abs(x).sum()
        assert abs(float(got[1]) - ref[1]) <= UTIL_TOL
    b, a = tu.fitaffine(x, y)
    b_r, a_r = ju.fitaffine(x, y)
    assert abs(float(b) - b_r) <= UTIL_TOL and abs(float(a) - a_r) <= UTIL_TOL
    img = rng.normal(0, 1, (16, 16))
    assert _rel(tu.subpixel_shift(img, 0.3, -0.7),
                ju.subpixel_shift(img, 0.3, -0.7)) <= UTIL_TOL
    assert _rel(tu.calc_psf_shift_subpix(img, 4),
                ju.calc_psf_shift_subpix(img, 4)) <= UTIL_TOL
    with pytest.raises(ValueError, match="square"):
        tu.subpixel_shift(img[:, :15], 0.3, 0.3)


def test_fitaffine_batch():
    """Every row of a batch runs its own bracketing and bisection: rows
    that need many steps and rows that need none (a line through the
    points, sigma_b = 0) come out as vip_tpu's serial fits."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(9, 150))
    Y = rng.uniform(0.5, 3, (9, 1)) * X + rng.uniform(-1, 1, (9, 1)) \
        + rng.standard_t(2, (9, 150)) * 0.3
    Y[0] = 1.5 * X[0] - 0.25
    B, A = tu.fitaffine(X, Y)
    assert B.shape == A.shape == (9,)
    for i in range(9):
        b_r, a_r = ju.fitaffine(X[i], Y[i])
        assert abs(float(B[i]) - b_r) <= UTIL_TOL
        assert abs(float(A[i]) - a_r) <= UTIL_TOL


def test_create_indices_and_diff_images(data):
    cube, angs, _ = data
    for angmin in (2.0, 5.0, 11.0, 60.0):
        got = ta.create_indices(angs, angmin, verbose=False)
        ref = ja.create_indices(angs, angmin, verbose=False)
        if ref[0] is None:
            assert got[0] is None and got[1] is None
            continue
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert list(got[2]) == list(ref[2])
    ineg, ipos, _ = ja.create_indices(angs, 5.0, verbose=False)
    for method in ("no", "total", "lsq", "l1"):
        got = ta.diff_images(cube[ipos], cube[ineg], 5, 12,
                             opt_method=method)
        ref = ja.diff_images(cube[ipos], cube[ineg], 5, 12,
                             opt_method=method)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=DIFF_TOL)
    with pytest.raises(ValueError, match="unknown"):
        ta.diff_images(cube[ipos], cube[ineg], 5, 12, opt_method="l2")


@pytest.mark.parametrize("homogeneous", [True, False])
def test_andromeda_core(data, homogeneous):
    cube, angs, psf = data
    angle_list = -angs
    psf_cube = ju.calc_psf_shift_subpix(psf / psf.max(), precision=8)
    ineg, ipos, _ = ja.create_indices(angle_list, 5.0, verbose=False)
    diff, gamma, _ = ja.diff_images(cube[ipos], cube[ineg], 5, 12, "lsq")
    kw = dict(rhomin=5, rhomax=12, gamma=gamma,
              homogeneous_variance=homogeneous)
    got = ta.andromeda_core(diff, ineg, ipos, angle_list, psf_cube, **kw)
    ref = ja.andromeda_core(diff, ineg, ipos, angle_list, psf_cube, **kw)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= MAP_TOL


@pytest.mark.parametrize("opt_method", ["lsq", "l1", "total"])
def test_andromeda(data, opt_method):
    cube, angs, psf = data
    kwargs = dict(oversampling_fact=1.2, filtering_fraction=0.3,
                  min_sep=0.5, annuli_width=1.0, roa=2,
                  opt_method=opt_method, nsmooth_snr=8, precision=8,
                  homogeneous_variance=True, verbose=False)
    got = ta.andromeda(cube=cube.copy(), angle_list=angs.copy(),
                       psf=psf.copy(), **kwargs)
    ref = ja.andromeda(cube=cube.copy(), angle_list=angs.copy(),
                       psf=psf.copy(), **kwargs)
    for g, r in zip(got[:6], ref[:6]):
        assert _rel(g, r) <= MAP_TOL
    assert got[6] == ref[6]
    # the companion at (+8, +3) of the centre stands out
    snr_norm = got[2].numpy()
    peak = np.unravel_index(np.argmax(snr_norm), snr_norm.shape)
    assert snr_norm.max() > 5
    assert abs(peak[0] - 27.5) <= DELTAPIX and abs(peak[1] - 22.5) \
        <= DELTAPIX


def test_normalize_snr_and_couronne():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:40, :40]
    d = np.sqrt((yy - 19.5) ** 2 + (xx - 19.5) ** 2)
    snr = rng.normal(0, 1, (40, 40))
    snr[(d < 4) | (d > 16)] = 0
    full = rng.normal(0, 1, (40, 40))     # reaches the edge: dnozero == dmax
    full[d < 3] = 0
    for image, nsmooth in ((snr, 4), (snr, 8), (snr, 2), (full, 4)):
        got = ta.normalize_snr(image, nsmooth_snr=nsmooth)
        ref = ja.normalize_snr(image, nsmooth_snr=nsmooth)
        assert _rel(got[0], ref[0]) <= MAP_TOL
        assert _rel(got[1], ref[1]) <= MAP_TOL
    with pytest.raises(RuntimeError, match="prof_snr"):
        ta.normalize_snr(snr, nsmooth_snr=0)
    with pytest.raises(RuntimeError, match="prof_snr"):
        ja.normalize_snr(snr, nsmooth_snr=0)
    assert _rel(ta.couronne_img(snr, 19.5),
                ja.couronne_img(snr, 19.5)) <= MAP_TOL


@pytest.fixture(scope="module")
def golden_ds():
    if not os.path.exists(os.path.join(GOLDEN_DIR, "meta.npz")):
        pytest.skip("golden snapshots not generated")
    ds = input_dataset_cached()
    meta = np.load(os.path.join(GOLDEN_DIR, "meta.npz"))
    ds["expected_yx"] = [tuple(meta["planet_yx"]),
                         tuple(meta["injected_yx"])]
    return ds


def check_detection(frame, ds, name):
    """The 3-px oracle of tests/test_golden.py with the port's own
    ``detection``: each planted companion that VIP found on golden
    ``name`` is found."""
    yy, xx = tmet.detection(frame, fwhm=ds["fwhm"], mode="lpeaks",
                            bkg_sigma=5, matched_filter=False, mask=True,
                            snr_thresh=SNR_THRESH, plot=False, debug=False,
                            full_output=False, verbose=False)
    vip = np.load(os.path.join(GOLDEN_DIR, f"{name}_detect.npy"))

    def near(ys, xs, c):
        return any(abs(y - c[0]) <= DELTAPIX and abs(x - c[1]) <= DELTAPIX
                   for y, x in zip(np.atleast_1d(ys), np.atleast_1d(xs)))

    found_by_vip = [c for c in ds["expected_yx"]
                    if near(vip[:, 0], vip[:, 1], c)]
    assert found_by_vip, f"{name}: VIP found no planted companion"
    for c in found_by_vip:
        assert near(yy, xx, c), f"{name}: companion at {c} not recovered"


@pytest.mark.parametrize("name", ["andro_adi", "androl1_adi"])
def test_golden_andromeda(golden_ds, name):
    kwargs = {n: kw for n, _, kw, _ in invprob_configs(golden_ds)}[name]
    out = ta.andromeda(cube=golden_ds["cube"].copy(),
                       angle_list=golden_ds["angles"],
                       psf=golden_ds["psfn"], **kwargs)
    contrast, snr_norm = out[0].numpy(), out[2].numpy()
    ref_c = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    ref_s = np.load(os.path.join(
        GOLDEN_DIR, f"{name.replace('_adi', '')}_snr_adi.npy"))
    assert float(np.nanmax(np.abs(contrast - ref_c))) <= FRAME_TOL
    assert float(np.nanmax(np.abs(snr_norm - ref_s))) <= FRAME_TOL
    check_detection(snr_norm, golden_ds, name)

"""Port's PCA grid, single-annulus PCA, ``pca(ncomp=tuple)``, ``left_eigv``
and CEVR against vip_tpu and the committed goldens, on the CPU at
float64.

- ``pca_grid`` (full-frame and annular, every ``fmerit``; the device
  branch with either rotation and the rotation-options branch),
  ``pca_annulus``, ``pca`` with a grid, a float ``ncomp`` or
  ``left_eigv``, and ``SVDecomposer``: the same float64 SVDs from another
  library, within 1e-10 of max(|ref|, 1). Frames, residuals and
  reconstructions are compared, not singular vectors (defined up to
  sign).
- The goldens pca_grid_adi, pca_left_eigv_adi and pca_cevr_adi at ≤1e-5
  max abs (tests/test_golden.py:28) with the port's own ``detection`` as
  the 3-px oracle.
- ``pca(ncomp=tuple, source_xy=...)`` without ``full_output`` imports no
  pandas.
"""

import os
import subprocess
import sys

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


@pytest.fixture(autouse=True)
def no_figures():
    """pca(ncomp=tuple, source_xy=...) plots, as in vip_tpu; close what it
    opens."""
    yield
    if "matplotlib.pyplot" in sys.modules:
        sys.modules["matplotlib.pyplot"].close("all")


TOL = 1e-10
FRAME_TOL = 1e-5    # tests/test_golden.py:28
DELTAPIX = 3        # tests/test_golden.py:29
SRC = (22, 12)


def _err(got, ref):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.fixture(scope="module")
def small():
    cube, angles = make_adi_cube(n=24, size=32)
    ref = make_adi_cube(n=12, size=32, rng=np.random.default_rng(9))[0]
    return cube, angles, ref


@pytest.mark.parametrize("kw", [
    dict(range_pcs=(1, 5), source_xy=SRC, fwhm=4),
    dict(range_pcs=(1, 5), source_xy=SRC, fwhm=4, fmerit="px"),
    dict(range_pcs=(1, 6, 2), source_xy=SRC, fwhm=4, fmerit="max"),
    dict(range_pcs=(2, 6), source_xy=SRC, fwhm=4, scaling="temp-mean",
         collapse="mean"),
    dict(range_pcs=(1, 4), mode="annular", source_xy=SRC, fwhm=4,
         annulus_width=8),
    dict(range_pcs=(1, 3), mode="annular", source_xy=SRC, fwhm=4,
         annulus_width=8, fmerit="px", imlib="vip-fft-small"),
    dict(range_pcs=[2, 4], full_output=True),
    dict(range_pcs=(1, 3), imlib="vip-fft-small"),
    dict(range_pcs=(1, 3), collapse="sum"),
    dict(range_pcs=(1, 3), imlib="vip-fft", interpolation="lanczos4",
         nproc=1),
    dict(range_pcs=(1, 3), collapse="max"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()
                           if k != "source_xy"))
def test_pca_grid_vs_vip_tpu(small, kw):
    cube, angles, _ = small
    ref = jps.pca_grid(cube.copy(), angles, plot=False, verbose=False, **kw)
    got = tps.pca_grid(cube.copy(), angles, plot=False, verbose=False, **kw)
    if "source_xy" in kw:
        cubeout, finalfr, df, opt = got
        assert opt == ref[3]
        assert _err(cubeout, ref[0]) <= TOL and _err(finalfr, ref[1]) <= TOL
        np.testing.assert_allclose(df["S/Ns"], ref[2]["S/Ns"], rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(df["fluxes"], ref[2]["fluxes"],
                                   rtol=1e-10, atol=1e-10)
        assert list(df["PCs"]) == list(ref[2]["PCs"])
    elif kw.get("full_output"):
        assert got[1] == ref[1] and _err(got[0], ref[0]) <= TOL
    else:
        assert got.dtype == torch.float64 and _err(got, ref) <= TOL


def test_pca_grid_rdi_vs_vip_tpu(small):
    cube, angles, cube_ref = small
    kw = dict(range_pcs=(1, 4), cube_ref=cube_ref, plot=False,
              verbose=False)
    assert _err(tps.pca_grid(cube.copy(), angles, **kw),
                jps.pca_grid(cube.copy(), angles, **kw)) <= TOL


@pytest.mark.parametrize("kw", [
    dict(), dict(collapse=None), dict(angs=None), dict(scaling="temp-mean"),
    dict(angs=None, collapse=None), dict(use_ref=True)])
def test_pca_annulus_vs_vip_tpu(small, kw):
    cube, angles, cube_ref = small
    kw = dict(kw)
    angs = kw.pop("angs", angles)
    if kw.pop("use_ref", False):
        kw["cube_ref"] = cube_ref
    args = (angs, 3, 8, 10.5)
    assert _err(tps.pca_annulus(cube.copy(), *args, **kw),
                jps.pca_annulus(cube.copy(), *args, **kw)) <= TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=(1, 3), source_xy=SRC, fwhm=4),
    dict(ncomp=(1, 3), source_xy=SRC, fwhm=4, full_output=True),
    dict(ncomp=[1, 3]),
    dict(ncomp=(1, 4), full_output=True),
    dict(ncomp=(1, 3), med_of_npcs=True),
    dict(ncomp=(1, 3), med_of_npcs=True, full_output=True, source_xy=SRC,
         fwhm=4),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()
                           if k != "source_xy"))
def test_pca_grid_route_vs_vip_tpu(small, kw):
    cube, angles, _ = small
    ref = jps.pca(cube.copy(), angles, verbose=False, **kw)
    got = tps.pca(cube.copy(), angles, verbose=False, **kw)
    if not isinstance(ref, tuple):
        assert _err(got, ref) <= TOL
        return
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, list):
            assert g == r
        elif hasattr(r, "columns"):
            np.testing.assert_allclose(g["S/Ns"], r["S/Ns"], rtol=1e-10,
                                       atol=1e-10)
        else:
            assert _err(g, r) <= TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=3, left_eigv=True),
    dict(ncomp=3, left_eigv=True, full_output=True),
    dict(ncomp=3, left_eigv=True, scaling="temp-standard"),
    dict(ncomp=0.9),
    dict(ncomp=0.5, svd_mode="eigen", full_output=True),
    dict(ncomp=0.99, scaling="temp-mean"),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_pca_left_eigv_and_cevr_vs_vip_tpu(small, kw):
    cube, angles, _ = small
    ref = jps.pca(cube.copy(), angles, verbose=False, **kw)
    got = tps.pca(cube.copy(), angles, verbose=False, **kw)
    if not isinstance(ref, tuple):
        assert _err(got, ref) <= TOL
        return
    # frame, pcs (up to sign: skipped), recon, residuals, derotated
    for i in (0, 2, 3, 4):
        assert _err(got[i], ref[i]) <= TOL


def test_left_eigv_with_a_reference_raises(small):
    cube, angles, cube_ref = small
    with pytest.raises(NotImplementedError):
        tps.pca(cube, angles, cube_ref=cube_ref, left_eigv=True,
                verbose=False)


def test_svdecomposer_vs_vip_tpu(small):
    from vip_tpu.psfsub.svd import SVDecomposer as JSVD

    cube, _, _ = small
    for kw in (dict(mode="fullfr"), dict(mode="annular", inrad=4,
                                         outrad=12)):
        ref = JSVD(cube, svd_mode="lapack", verbose=False, **kw)
        got = tps.SVDecomposer(cube, svd_mode="lapack", verbose=False, **kw)
        assert got.cevr_to_ncomp(0.9) == ref.cevr_to_ncomp(0.9)
        assert got.cevr_to_ncomp((0.5, 0.95)) == ref.cevr_to_ncomp(
            (0.5, 0.95))
        np.testing.assert_allclose(got.cevr, ref.cevr, rtol=0, atol=1e-12)
        t_ref = ref.get_cevr(ncomp_list=[1, 2, 5], plot=False)
        t_got = got.get_cevr(ncomp_list=[1, 2, 5], plot=False)
        np.testing.assert_allclose(t_got["cevr"], t_ref["cevr"], rtol=0,
                                   atol=1e-12)


_NO_PANDAS = """
import sys
sys.modules["pandas"] = None          # importing pandas now raises
import numpy as np
import vip_tpu_torch
vip_tpu_torch.set_device("cpu")
from vip_tpu_torch.psfsub import pca, pca_grid
rng = np.random.default_rng(0)
cube = rng.standard_normal((12, 32, 32))
angles = np.linspace(0, 30, 12)
frame = pca(cube, angles, ncomp=(1, 3), source_xy=(22, 12), fwhm=4,
            verbose=False)
grid = pca_grid(cube, angles, range_pcs=(1, 3), verbose=False, plot=False)
print(tuple(frame.shape), tuple(grid.shape))
"""


def test_grid_without_full_output_imports_no_pandas():
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS],
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))),
                         env=dict(os.environ, MPLBACKEND="Agg"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "(32, 32) (3, 32, 32)"


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


@pytest.mark.parametrize("name", ["pca_grid_adi", "pca_left_eigv_adi",
                                  "pca_cevr_adi"])
def test_golden_frame(golden_ds, name):
    for cname, fn, kwargs, _ in psfsub_configs(golden_ds):
        if cname == name:
            assert fn == "pca"
            mine = tps.pca(cube=golden_ds["cube"].copy(),
                           angle_list=golden_ds["angles"], **kwargs)
            break
    else:
        raise KeyError(name)
    mine = mine.numpy()
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    err = float(np.max(np.abs(mine - ref)))
    assert err <= FRAME_TOL, f"{name}: max abs err {err:.2e}"
    _check_detection(mine, golden_ds)

"""Port's public ``psfsub.pca_annular`` against vip_tpu and the committed
goldens, on the CPU at float64.

- The host-orchestrated branch on a 40x48x48 cube (int, per-annulus tuple,
  list and "auto" ``ncomp``, RDI ``cube_ref``, ``left_eigv``), and the
  device-resident branch on a 128x32x32 cube (``_gram_path_enabled``
  holds from 128 frames), each with the 'vip-fft' and 'vip-fft-small'
  derotations. Per-frame SVDs and eigh's of small libraries in another
  LAPACK: 1e-8 of max(|ref|, 1), vip_tpu's own host-vs-Gram bound
  (vip_tpu/psfsub/pca_local.py:632-633).
- The goldens pca_ann_adi, pca_ann_left_eigv_adi and pca_ann_auto_adi
  (VIP's own frames on the NACO replica, tests/golden/) at ≤1e-5 max abs,
  the contract of tests/test_golden.py:28, with the port's own
  ``detection`` as the 3-px oracle.
"""

import os

import numpy as np
import pytest
import torch

import vip_tpu_torch

from conftest import make_adi_cube
from gen_golden import (GOLDEN_DIR, SNR_THRESH, input_checksum,
                        input_dataset_cached, psfsub_configs)
from test_torch_annular import one_blas_thread  # noqa: F401 (autouse)
import vip_tpu.psfsub as jps
from vip_tpu.psfsub import pca_local as jlocal
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.ops import median, shear
from vip_tpu_torch.psfsub import pca_local

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


TOL = 1e-8
FRAME_TOL = 1e-5    # tests/test_golden.py:28
DELTAPIX = 3        # tests/test_golden.py:29


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.fixture(scope="module")
def host_cube():
    cube, angles = make_adi_cube(n=40, size=48)
    ref = make_adi_cube(n=16, size=48, rng=np.random.default_rng(5))[0]
    return cube, angles, ref


@pytest.mark.parametrize("imlib", ["vip-fft", "vip-fft-small"])
@pytest.mark.parametrize("case", ["int", "tuple", "list", "auto", "rdi",
                                  "left_eigv"])
def test_pca_annular_host_path_vs_vip_tpu(host_cube, case, imlib):
    cube, angles, cube_ref = host_cube
    kw = {"int": dict(ncomp=3, n_segments=2),
          "tuple": dict(ncomp=(1, 2, 3, 2, 1, 2)),
          "list": dict(ncomp=[1, 3]),
          "auto": dict(ncomp="auto"),
          "rdi": dict(ncomp=3, cube_ref=cube_ref),
          "left_eigv": dict(ncomp=3, n_segments="auto", left_eigv=True),
          }[case]
    ref = jps.pca_annular(cube.copy(), angles, imlib=imlib, verbose=False,
                          **kw)
    got = tps.pca_annular(cube.copy(), angles, imlib=imlib, verbose=False,
                          **kw)
    if case == "list":
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert _err(g, r) <= TOL
        return
    assert got.dtype == torch.float64 and tuple(got.shape) == (48, 48)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("imlib", ["vip-fft", "vip-fft-small"])
def test_pca_annular_resident_path_vs_vip_tpu(imlib):
    cube, angles = make_adi_cube(n=128, size=32)
    assert pca_local._gram_path_enabled(128)
    kw = dict(ncomp=3, n_segments=2, imlib=imlib, full_output=True,
              verbose=False)
    ref = jps.pca_annular(cube.copy(), angles, **kw)
    before = (median.launches, shear.launches, shear.small_launches)
    got = tps.pca_annular(cube.copy(), angles, **kw)
    assert (median.launches, shear.launches, shear.small_launches) == before
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert _err(g, r) <= TOL


def test_pca_annular_resident_chunk_is_vip_tpus():
    """The fft-small derotation pairs frames in packs, so the resident
    path's chunk must be vip_tpu's (pca_local.py:183-186)."""
    for n, y in ((1000, 512), (128, 32), (300, 1024), (77, 64)):
        for rot_mode in ("fft", "fft-small"):
            canvas = (4 * y) ** 2 * 8 if rot_mode == "fft" \
                else (int(1.25 * y) + 2) ** 2 * 8
            want = int(min(n, 128, max(8, 1.6e9 // canvas)))
            assert pca_local._resident_chunk(n, y, rot_mode) == want


def test_resident_switches_match_vip_tpu(monkeypatch):
    for n in (10, 127, 128, 511, 512, 1000):
        assert pca_local._gram_path_enabled(n) == \
            jlocal._gram_path_enabled(n)
        for svd_mode in ("lapack", "eigen", "randsvd"):
            assert pca_local._resident_method(n, svd_mode) == \
                jlocal._resident_method(n, svd_mode)
    monkeypatch.setenv("VIP_TPU_ANNULAR_GRAM", "0")
    monkeypatch.setenv("VIP_TPU_ANNULAR_METHOD", "eigh")
    assert not pca_local._gram_path_enabled(1000)
    assert pca_local._resident_method(1000, "randsvd") == "eigh"


def test_do_pca_patch_vs_vip_tpu(host_cube):
    cube, angles, _ = host_cube
    yy, xx = tps.pca_local.get_annulus_segments((48, 48), 8, 4, 1)[0]
    matrix = cube[:, yy, xx]
    for ncomp in (3, [1, 2]):
        args = (matrix, 7, angles, 4, 3.0, 10, "lapack", ncomp, 2, 20, 0.1,
                None, None)
        ref = jlocal.do_pca_patch(*args)
        got = pca_local.do_pca_patch(*args)
        assert got[1:] == tuple(ref[1:])
        if isinstance(ncomp, list):
            for g, r in zip(got[0], ref[0]):
                assert _err(g, r) <= TOL
        else:
            assert _err(got[0], ref[0]) <= TOL


def test_pca_annular_4d_waits(host_cube):
    """Slice 7 ported the 4-d cubes: two channels reduced one by one and
    their frames averaged, as vip_tpu; a ``scale_list`` beside a 3-d cube
    is ignored by both."""
    cube, angles, _ = host_cube
    cube4 = np.stack([cube, cube[::-1].copy()])
    kw = dict(ncomp=2, asize=6, verbose=False)
    assert _err(tps.pca_annular(cube4, angles, **kw),
                jps.pca_annular(cube4, angles, **kw)) <= TOL
    assert _err(tps.pca_annular(cube, angles, scale_list=np.ones(2), **kw),
                jps.pca_annular(cube, angles, scale_list=np.ones(2),
                                **kw)) <= TOL


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
            assert fn == "pca_annular"
            return tps.pca_annular(cube=ds["cube"].copy(),
                                   angle_list=ds["angles"], **kwargs)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["pca_ann_adi", "pca_ann_left_eigv_adi",
                                  "pca_ann_auto_adi"])
def test_golden_frame(golden_ds, name):
    mine = _golden_run(golden_ds, name).numpy()
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    err = float(np.max(np.abs(mine - ref)))
    assert err <= FRAME_TOL, f"{name}: max abs err {err:.2e}"
    _check_detection(mine, golden_ds)


def _check_detection(frame, ds):
    """3-px detection oracle (tests/test_golden.py:62-82), with the port's
    own detection."""
    from vip_tpu_torch.metrics import detection

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

"""The port's streamed PCA (``psfsub.pca_incremental``, ``pca(batch=)``)
and its FITS reader against vip_tpu, on the CPU at float64.

- The lazy HDU slices frames as the whole cube does.
- No more than ``batch`` frames are read at a time (the wrapper of
  tests/test_pca_incremental.py:31).
- Frames and residuals equal vip_tpu's ``pca_incremental`` within 1e-8 of
  max(|ref|, 1), at batch sizes that divide the frame count and sizes
  that do not: the same merges in the same float64 arithmetic, through
  another library's eigh.
- The float ``batch`` sizes batches from host memory; the bf16 wire errs
  within 1e-2 of the cube's dynamic range (tests/test_pca_incremental.py:
  73-83).
- ``pca(batch=)`` is ``pca_incremental``; RDI with a batch raises.
- The golden pca_incr_adi (VIP's frame on the NACO replica) at 1e-5, with
  the port's own detection as the 3-px oracle (tests/test_golden.py:28):
  it finds each source VIP's detection found on that frame
  (pca_incr_adi_detect.npy: at ncomp 1 only the injected companion).
"""

import os

import numpy as np
import pytest
import torch

import vip_tpu_torch
from conftest import make_adi_cube
from gen_golden import (GOLDEN_DIR, SNR_THRESH, input_checksum,
                        input_dataset_cached, psfsub_configs)
from vip_tpu.psfsub.utils_pca import pca_incremental as jinc
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.fits import open_fits, write_fits
from vip_tpu_torch.psfsub import utils_pca
from vip_tpu_torch.psfsub.utils_pca import pca_incremental

torch.set_num_threads(1)
TOL = 1e-8
FRAME_TOL = 1e-5    # tests/test_golden.py:28
DELTAPIX = 3        # tests/test_golden.py:29


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(scope="module")
def fits_cube(tmp_path_factory):
    cube, angs = make_adi_cube(n=24, size=50)
    path = str(tmp_path_factory.mktemp("ooc") / "cube.fits")
    write_fits(path, cube.astype(np.float32), verbose=False)
    return path, cube.astype(np.float32), angs


def _err(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(
        np.abs(ref).max(), 1.0)


def test_lazy_hdu_frame_slicing(fits_cube):
    path, cube, _ = fits_cube
    lazy = open_fits(path, n=0, return_memmap=True, verbose=False)
    assert lazy.shape == cube.shape and len(lazy) == cube.shape[0]
    np.testing.assert_array_equal(lazy[3:9], cube[3:9])
    np.testing.assert_array_equal(lazy[-1], cube[-1])
    np.testing.assert_array_equal(lazy[::5], cube[::5])
    np.testing.assert_array_equal(lazy.data, cube)
    np.testing.assert_array_equal(open_fits(path, verbose=False), cube)


def test_fits_reads_what_vip_tpu_writes(fits_cube, tmp_path):
    from vip_tpu.fits import open_fits as jopen, write_fits as jwrite

    path, cube, _ = fits_cube
    np.testing.assert_array_equal(jopen(path, verbose=False), cube)
    other = str(tmp_path / "theirs.fits")
    jwrite(other, cube[:5], verbose=False)
    np.testing.assert_array_equal(open_fits(other, verbose=False), cube[:5])


class _CountingCube:
    """Lazy-cube wrapper that records the largest read and forbids
    materializing the whole cube (tests/test_pca_incremental.py:31)."""

    def __init__(self, inner):
        self.inner = inner
        self.max_read = 0

    @property
    def shape(self):
        return self.inner.shape

    def __getitem__(self, key):
        out = self.inner[key]
        self.max_read = max(self.max_read,
                            out.shape[0] if out.ndim == 3 else 1)
        return out

    @property
    def data(self):
        raise AssertionError("pca_incremental materialized the full cube")


def test_streams_no_more_than_batch_frames(fits_cube):
    path, cube, angs = fits_cube
    wrap = _CountingCube(open_fits(path, n=0, return_memmap=True,
                                   verbose=False))
    frame = pca_incremental(wrap, angs, batch=6, ncomp=3, verbose=False)
    assert wrap.max_read <= 6
    assert frame.shape == cube.shape[1:] and np.isfinite(frame).all()


@pytest.mark.parametrize("batch", [6, 7, 24])
def test_frame_and_residuals_vs_vip_tpu(fits_cube, batch):
    path, _, angs = fits_cube
    kw = dict(batch=batch, ncomp=3, verbose=False)
    assert _err(pca_incremental(path, angs, **kw), jinc(path, angs, **kw)) \
        <= TOL
    ours = pca_incremental(path, angs, return_residuals=True, **kw)
    theirs = jinc(path, angs, return_residuals=True, **kw)
    assert ours.shape == theirs.shape and _err(ours, theirs) <= TOL


def test_full_output_vs_vip_tpu(fits_cube):
    path, cube, angs = fits_cube
    kw = dict(batch=10, ncomp=2, collapse="mean", verbose=False,
              full_output=True)
    ours, theirs = pca_incremental(path, angs, **kw), jinc(path, angs, **kw)
    assert ours[1] is None and ours[2].shape == (2,) + cube.shape[1:]
    assert _err(ours[0], theirs[0]) <= TOL
    assert _err(ours[3], theirs[3]) <= TOL
    # the PCs up to sign
    for p, q in zip(ours[2], np.asarray(theirs[2])):
        assert min(np.abs(p - q).max(), np.abs(p + q).max()) <= 1e-6


def test_device_cache_off_gives_the_same_frame(fits_cube, monkeypatch):
    path, _, angs = fits_cube
    cached = pca_incremental(path, angs, batch=7, ncomp=3, verbose=False)
    monkeypatch.setattr(utils_pca, "_CACHE_FRACTION", 0.0)
    streamed = pca_incremental(path, angs, batch=7, ncomp=3, verbose=False)
    np.testing.assert_array_equal(cached, streamed)


def test_float_batch_sizes_from_host_memory(fits_cube, monkeypatch):
    from vip_tpu_torch.config import mem

    path, cube, angs = fits_cube
    frame_bytes = cube.shape[1] * cube.shape[2] * 8
    monkeypatch.setattr(mem, "get_available_memory",
                        lambda verbose=True: 20 * frame_bytes)
    wrap = _CountingCube(open_fits(path, n=0, return_memmap=True,
                                   verbose=False))
    got = pca_incremental(wrap, angs, batch=0.25, ncomp=3, verbose=False)
    assert wrap.max_read == 5
    assert _err(got, jinc(path, angs, batch=5, ncomp=3, verbose=False)) \
        <= TOL
    with pytest.raises(ValueError):
        pca_incremental(path, angs, batch=1.5, verbose=False)


def test_bf16_wire_bound(fits_cube):
    path, cube, angs = fits_cube
    exact = pca_incremental(path, angs, batch=6, ncomp=3, verbose=False)
    approx = pca_incremental(path, angs, batch=6, ncomp=3, verbose=False,
                             wire_dtype="bfloat16")
    assert 0 < np.abs(approx - exact).max() < 1e-2 * np.abs(cube).max()


def test_pca_batch_is_pca_incremental(fits_cube):
    path, cube, angs = fits_cube
    ref = pca_incremental(path, angs, batch=8, ncomp=3, verbose=False)
    np.testing.assert_array_equal(
        tps.pca(path, angs, batch=8, ncomp=3, verbose=False), ref)
    frame, pcs, medians = tps.pca(cube, angs, batch=8, ncomp=3,
                                  verbose=False, full_output=True)
    assert _err(frame, ref) <= TOL
    assert pcs.shape == (3,) + cube.shape[1:] and medians.shape[0] == 3
    with pytest.raises(ValueError):
        tps.pca(cube, angs, batch=8, cube_ref=cube[:6], verbose=False)
    # pixel_mesh: a one-rank mesh (a gloo group of this process) gives the
    # frame without it; a host-route configuration refuses the mesh with
    # vip_tpu's error
    from vip_tpu_torch.config import frame_mesh

    mesh = frame_mesh(axis_name="px")
    np.testing.assert_allclose(
        pca_incremental(path, angs, batch=8, ncomp=3, verbose=False,
                        pixel_mesh=mesh), ref, rtol=0,
        atol=TOL * max(np.abs(ref).max(), 1.0))
    with pytest.raises(ValueError, match="pixel_mesh"):
        pca_incremental(path, angs, batch=8, pixel_mesh=mesh,
                        imlib="skimage", verbose=False)


def test_golden_pca_incr_adi():
    if not os.path.exists(os.path.join(GOLDEN_DIR, "meta.npz")):
        pytest.skip("golden snapshots not generated")
    from vip_tpu_torch.metrics import detection

    ds = input_dataset_cached()
    meta = np.load(os.path.join(GOLDEN_DIR, "meta.npz"))
    assert input_checksum(ds) == bytes(meta["checksum"]).hex()
    kwargs = next(kw for name, fn, kw, _ in psfsub_configs(ds)
                  if name == "pca_incr_adi")
    mine = tps.pca(cube=ds["cube"].copy(), angle_list=ds["angles"], **kwargs)
    ref = np.load(os.path.join(GOLDEN_DIR, "pca_incr_adi.npy"))
    err = float(np.max(np.abs(mine - ref)))
    assert err <= FRAME_TOL, f"pca_incr_adi: max abs err {err:.2e}"
    table = detection(mine, fwhm=ds["fwhm"], mode="lpeaks", bkg_sigma=5,
                      matched_filter=False, mask=True, snr_thresh=SNR_THRESH,
                      plot=False, debug=False, full_output=True,
                      verbose=False)
    yy = np.atleast_1d(np.asarray(table.y, dtype=float))
    xx = np.atleast_1d(np.asarray(table.x, dtype=float))
    expected = np.load(os.path.join(GOLDEN_DIR, "pca_incr_adi_detect.npy"))
    for ey, ex in expected:
        assert any(abs(y - ey) <= DELTAPIX and abs(x - ex) <= DELTAPIX
                   for y, x in zip(yy, xx)), \
            f"companion at {(ey, ex)} not recovered: {list(zip(yy, xx))}"

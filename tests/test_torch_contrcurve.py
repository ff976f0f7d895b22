"""The port's contrast curves and STIM maps against vip_tpu, on the CPU
at float64.

- ``aperture_flux`` (sum and mean) and ``noise_per_annulus``: 1e-10.
- ``throughput`` with the port's ``pca``: the patterns injected and
  reduced on the device (``inject_ladder_adi`` + ``pca_adi_pipeline``)
  equal the loop of black-box ``pca`` calls on host-injected cubes
  (1e-8), and vip_tpu's throughput.
- ``contrast_curve`` columns against vip_tpu's, 1e-6 relative; the
  pandas-free ``_contrast_curve`` gives the same columns.
- ``stim_map``, ``inverse_stim_map`` and ``normalized_stim_map``: 1e-10.
- ``_parse_batchable_pca`` takes the port's ``pca`` by identity, not by
  module name: vip_tpu's ``pca`` (whose module name starts with
  "vip_tpu" too) and a look-alike are not batched.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch
from conftest import make_adi_cube
from naco_replica import moffat_psf
import vip_tpu.metrics as jm
import vip_tpu.psfsub as jps
import vip_tpu_torch.metrics as tm
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.metrics.contrcurve import (_contrast_curve,
                                              _parse_batchable_pca)

torch.set_num_threads(1)
TOL = 1e-10
KW = dict(ncomp=3, svd_mode="lapack", collapse="median")


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(scope="module")
def data():
    cube, angles = make_adi_cube(n=16, size=41)
    return cube, angles, moffat_psf(size=15, fwhm=4.0)


def _err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(
        np.abs(ref).max(), 1.0)


def test_aperture_flux_and_noise_vs_vip_tpu(data):
    cube, _, _ = data
    frame = cube[3] - cube.mean(axis=0)
    yc, xc = [10.2, 20.0, 31.7], [15.5, 20.0, 8.3]
    for mean in (False, True):
        assert _err(tm.aperture_flux(frame, yc, xc, 4.0, mean=mean),
                    jm.aperture_flux(frame, yc, xc, 4.0, mean=mean)) <= TOL
    for kw in (dict(separation=1, fwhm=4.0),
               dict(separation=2, fwhm=3.5, init_rad=5, wedge=(30, 200))):
        for ours, theirs in zip(tm.noise_per_annulus(frame, **kw),
                                jm.noise_per_annulus(frame, **kw)):
            assert ours.shape == theirs.shape and _err(ours, theirs) <= TOL


def test_throughput_batched_equals_serial_and_vip_tpu(data):
    cube, angles, psf = data
    batched = tm.throughput(cube, angles, psf, 4.0, tps.pca, nbranch=2,
                            verbose=False, full_output=True, **KW)
    serial = tm.throughput(cube, angles, psf, 4.0, tps.pca, nbranch=2,
                           verbose=False, full_output=True,
                           batch_patterns=False, **KW)
    theirs = jm.throughput(cube, angles, psf, 4.0, jps.pca, nbranch=2,
                           verbose=False, full_output=True, **KW)
    assert batched[0].shape == (2, theirs[0].shape[1])
    for i in (0, 1, 3, 4, 5, 6):
        assert _err(batched[i], serial[i]) <= 1e-8
        assert _err(batched[i], theirs[i]) <= 1e-8


def test_contrast_curve_columns_vs_vip_tpu(data):
    cube, angles, psf = data
    kw = dict(plot=False, verbose=False, fc_snr=50, **KW)
    theirs = jm.contrast_curve(cube, angles, psf, 4.0, 0.1, 1e4, jps.pca,
                               **kw)
    ours = tm.contrast_curve(cube, angles, psf, 4.0, 0.1, 1e4, tps.pca, **kw)
    assert list(ours.columns) == list(theirs.columns)
    cols = _contrast_curve(cube, angles, psf, 4.0, 0.1, 1e4, tps.pca,
                           **kw)[0]
    for name in theirs.columns:
        ref = np.asarray(theirs[name])
        scale = max(np.abs(ref).max(), np.finfo(float).tiny)
        assert np.abs(np.asarray(ours[name]) - ref).max() <= 1e-6 * scale
        np.testing.assert_array_equal(cols[name], np.asarray(ours[name]))
    assert np.all((cols["throughput"] > 0) & (cols["throughput"] <= 1))


def test_contrast_curve_without_student_and_4d_raises(data):
    cube, angles, psf = data
    kw = dict(plot=False, verbose=False, student=False, smooth=False, **KW)
    theirs = jm.contrast_curve(cube, angles, psf, 4.0, 0.1, 1e4, jps.pca,
                               **kw)
    ours = _contrast_curve(cube, angles, psf, 4.0, 0.1, 1e4, tps.pca,
                           **kw)[0]
    assert list(ours) == list(theirs.columns)
    assert _err(ours["sensitivity_gaussian"],
                theirs["sensitivity_gaussian"]) <= 1e-6
    # a 4-d cube (slice 7) meets vip_tpu: one channel, the 4-d algo
    # reducing it channel by channel (tests/test_torch_ifs_more.py holds
    # the IFS cases)
    ours4 = _contrast_curve(cube[None], angles, psf[None], 4.0, 0.1, 1e4,
                            tps.pca, **kw)[0]
    theirs4 = jm.contrast_curve(cube[None], angles, psf[None], 4.0, 0.1,
                                1e4, jps.pca, **kw)
    assert _err(ours4["sensitivity_gaussian"],
                theirs4["sensitivity_gaussian"]) <= 1e-6
    # pattern_mesh: the patterns over a one-rank mesh (a gloo group of
    # this process) give the curve without it
    from vip_tpu_torch.config import frame_mesh

    on_mesh = _contrast_curve(cube, angles, psf, 4.0, 0.1, 1e4, tps.pca,
                              pattern_mesh=frame_mesh(axis_name="patterns"),
                              **kw)[0]
    for col in ours:
        assert _err(on_mesh[col], ours[col]) <= TOL, col


def test_stim_maps_vs_vip_tpu(data):
    cube, angles, _ = data
    resid = cube - cube.mean(axis=0)
    assert _err(tm.stim_map(resid), jm.stim_map(resid)) <= TOL
    assert _err(tm.inverse_stim_map(resid, angles),
                jm.inverse_stim_map(resid, angles)) <= TOL
    for mask in (None, 4):
        assert _err(tm.normalized_stim_map(resid, angles, mask=mask),
                    jm.normalized_stim_map(resid, angles, mask=mask)) <= TOL


def test_batchable_pca_by_identity():
    shape = (10, 32, 32)
    parsed = _parse_batchable_pca(shape, tps.pca, dict(KW))
    assert parsed == dict(ncomp=3, method="lapack", collapse="median",
                          rot_mode="fft", scaling=None)
    assert _parse_batchable_pca(shape, jps.pca, dict(KW)) is None

    def pca(*args, **kwargs):
        return tps.pca(*args, **kwargs)

    pca.__module__ = tps.pca.__module__
    assert _parse_batchable_pca(shape, pca, dict(KW)) is None
    assert _parse_batchable_pca(shape, tps.pca, dict(KW, ncomp=0.9)) is None
    assert _parse_batchable_pca(shape, tps.pca,
                                dict(KW, imlib="vip-fft-small"))["rot_mode"] \
        == "fft-small"
    assert _parse_batchable_pca((10, 31, 31), tps.pca,
                                dict(KW, imlib="vip-fft-small"))["rot_mode"] \
        == "fft"

"""The port's completeness curves and ROC detection maps against vip_tpu,
on the CPU at float64.

- ``_estimate_snr_fc`` (one injection, one reduction, the detection
  margin) in both S/N branches, approximate and exact: 1e-8 relative.
- ``_run_batch_device`` (every position injected and reduced on the
  device) equals the serial map of ``_estimate_snr_fc``: the same
  margins, 1e-8.
- ``completeness_curve`` and ``completeness_map`` find vip_tpu's levels
  (the same search over the same detections: 1e-10 relative).
- ``detect_sources`` and ``compute_binary_map``: the same labels, counts
  and maps.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch
from conftest import make_adi_cube
from naco_replica import moffat_psf
import vip_tpu.metrics.completeness as jc
import vip_tpu.metrics.roc as jroc
import vip_tpu.psfsub as jps
import vip_tpu_torch.metrics.completeness as tc
import vip_tpu_torch.metrics.roc as troc
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.fm import normalize_psf
from vip_tpu_torch.metrics import snrmap

torch.set_num_threads(1)
KW = dict(ncomp=3, svd_mode="lapack", collapse="median")
FWHM, STARPHOT = 4.0, 1e4


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(scope="module")
def data():
    cube, angles = make_adi_cube(n=16, size=41)
    psf = moffat_psf(size=15, fwhm=FWHM)
    psfn = normalize_psf(psf, fwhm=FWHM, size=13, verbose=False)
    frame = np.asarray(tps.pca(cube, angles, verbose=False, **KW))
    empty = {approx: snrmap(frame, FWHM, approximated=approx,
                            verbose=False).numpy()
             for approx in (True, False)}
    return cube, angles, psf, psfn, empty


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


@pytest.mark.parametrize("approximated", [True, False])
def test_estimate_snr_fc_vs_vip_tpu(data, approximated):
    cube, angles, _, psfn, empty = data
    for b in (0, 2):
        args = (11.0, b, 2e-3, 5, cube, psfn, angles, FWHM)
        ours = tc._estimate_snr_fc(*args, tps.pca, KW, empty[approximated],
                                   STARPHOT, approximated=approximated)
        theirs = jc._estimate_snr_fc(*args, jps.pca, KW, empty[approximated],
                                     STARPHOT, approximated=approximated)
        assert ours[1] == theirs[1] == b
        assert _rel(ours[0], theirs[0]) <= 1e-8


@pytest.mark.parametrize("approximated", [True, False])
def test_run_batch_device_equals_serial(data, approximated):
    cube, angles, _, psfn, empty = data
    args = (12.0, [0, 1, 3], 1.5e-3, 5, cube, psfn, angles, FWHM, tps.pca,
            KW, empty[approximated], STARPHOT, approximated)
    device = tc._run_batch_device(*args)
    serial = [tc._estimate_snr_fc(12.0, b, 1.5e-3, 5, cube, psfn, angles,
                                  FWHM, tps.pca, KW, empty[approximated],
                                  STARPHOT, approximated=approximated)
              for b in (0, 1, 3)]
    assert [b for _, b in device] == [b for _, b in serial]
    for (m, _), (s, _) in zip(device, serial):
        assert _rel(m, s) <= 1e-8
    # other algos and annular ones take the serial map
    assert tc._run_batch_device(*args[:8], jps.pca, *args[9:]) is None


def test_completeness_curve_vs_vip_tpu(data):
    cube, angles, psf, _, _ = data
    kw = dict(an_dist=[9, 12], ini_contrast=[1e-3, 1e-3],
              starphot=STARPHOT, n_fc=5, completeness=0.8, algo_dict=KW,
              plot=False, verbose=False)
    ours = tc.completeness_curve(cube, angles, psf, FWHM, tps.pca, **kw)
    theirs = jc.completeness_curve(cube, angles, psf, FWHM, jps.pca, **kw)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_allclose(ours[1], theirs[1], rtol=1e-10)
    assert np.all(ours[1] != 1e-3)      # the search moved


def test_completeness_map_vs_vip_tpu(data):
    cube, angles, psf, _, _ = data
    kw = dict(starphot=STARPHOT, n_fc=4, algo_dict=KW, verbose=False)
    ours = tc.completeness_map(cube, angles, psf, FWHM, tps.pca, [12],
                               [1.5e-3], **kw)
    theirs = jc.completeness_map(cube, angles, psf, FWHM, jps.pca, [12],
                                 [1.5e-3], **kw)
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o, t, rtol=1e-10)


def test_detect_sources_and_binary_map_vs_vip_tpu():
    rng = np.random.default_rng(8)
    frame = rng.standard_normal((40, 40))
    yy, xx = np.mgrid[:40, :40]
    for (y, x, a) in ((12, 30, 6.0), (28, 9, 4.0), (20, 20, 8.0)):
        frame += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / 4.0)
    for thr, npix, conn in ((2.0, 1, 4), (3.0, 3, 8), (50.0, 1, 4)):
        ours = troc.detect_sources(frame, thr, npix, conn)
        theirs = jroc.detect_sources(frame, thr, npix, conn)
        assert (ours is None) == (theirs is None)
        if ours is not None:
            np.testing.assert_array_equal(ours.data, theirs.data)
            assert [(s.label, s.area) for s in ours.segments] == \
                [(s.label, s.area) for s in theirs.segments]
    for inj in ((30, 12), [(30, 12), (9, 28)]):
        ours = troc.compute_binary_map(frame, [1.0, 2.5, 4.0, 20.0], inj,
                                       FWHM, npix=2)
        theirs = jroc.compute_binary_map(frame, [1.0, 2.5, 4.0, 20.0], inj,
                                         FWHM, npix=2)
        assert ours[0] == theirs[0] and ours[1] == theirs[1]
        for a, b in zip(ours[2], theirs[2]):
            np.testing.assert_array_equal(a, b)

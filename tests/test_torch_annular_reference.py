"""The benchmark's plain references of annular PCA-ADI and full-frame
median-ADI (``benchmark/references/pca_annular.py``, ``median_sub.py``)
against the port on the CPU in float64, on small sequences from the
benchmark's own generator (its speckles give the spectrum on which the
subspace iteration converges):

- ``pca_annular`` on its three routes (the host branch below 128 frames,
  the resident branch's exact eigh at 128, its subspace iteration forced
  with ``VIP_TPU_ANNULAR_METHOD``) within 1e-8 of max(|ref|, 1),
  vip_tpu's own host-vs-Gram bound;
- ``median_sub(mode="fullfr")`` within 1e-10;
- the reference's geometry worked by hand, and against the port's
  ``_find_indices_adi``, ``_define_annuli`` and ``get_annulus_segments``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import vip_tpu_torch
from vip_tpu_torch.preproc import derotation
from vip_tpu_torch.psfsub import median_sub, pca_annular
from vip_tpu_torch.var import shapes

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from yardstick import harness, sequences  # noqa: E402

annular_ref = harness.load_module("references", "pca_annular")
medsub_ref = harness.load_module("references", "median_sub")

SEED = 2 ** 31 + 21


@pytest.fixture(autouse=True)
def on_the_cpu():
    vip_tpu_torch.set_device("cpu")


def _sequence(cell_name, frames, frame_px):
    cfg = dict(harness.load_cell(cell_name).config, frames=frames,
               frame_px=frame_px, dtype="float64")
    return sequences.make_sequence(cfg, SEED, 0, torch.device("cpu"))


def _gap(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


@pytest.mark.parametrize("frames, method, ncomp", [
    (40, None, 4),             # host branch: a masked SVD a segment
    (128, None, 10),           # resident branch, exact eigh a frame
    (128, "subspace", 6),      # resident branch, subspace iteration
], ids=["host", "resident-eigh", "resident-subspace"])
def test_pca_annular_matches_the_reference(frames, method, ncomp,
                                           monkeypatch):
    if method is None:
        monkeypatch.delenv("VIP_TPU_ANNULAR_METHOD", raising=False)
    else:
        monkeypatch.setenv("VIP_TPU_ANNULAR_METHOD", method)
    seq = _sequence("adi256.pca_annular", frames, 32)
    kw = dict(fwhm=seq.extras["fwhm"], ncomp=ncomp, verbose=False)
    got = pca_annular(seq.cube, seq.angles, **kw)
    ref = annular_ref.reduce(seq.cube, seq.angles, kw)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert _gap(got, ref) < 1e-8


def test_median_sub_matches_the_reference():
    seq = _sequence("adi512.median_sub", 40, 32)
    kw = dict(mode="fullfr", imlib="vip-fft", verbose=False)
    got = median_sub(seq.cube, seq.angles, **kw)
    ref = medsub_ref.reduce(seq.cube, seq.angles, kw)
    assert got.dtype == torch.float64
    assert _gap(got, ref) < 1e-10


@pytest.mark.parametrize("kwargs", [
    dict(fwhm=3.0, ncomp=3, asize=2), dict(fwhm=3.0, ncomp=3, radius_int=4),
    dict(ncomp=3)], ids=["asize", "radius_int", "no-fwhm"])
def test_the_reference_refuses_what_it_does_not_compute(kwargs):
    seq = _sequence("adi256.pca_annular", 20, 16)
    with pytest.raises(ValueError):
        annular_ref.reduce(seq.cube, seq.angles, kwargs)


def test_library_by_hand():
    angles = np.arange(10.0)
    # within 2.5 deg of frame 5: frames 3-7; the library is the rest
    assert annular_ref.library(angles, 5, 2.5).tolist() == [0, 1, 2, 8, 9]
    # cut to 3 by |dPA| (3, 3, 4, 4, 5 for frames 2, 8, 1, 9, 0): argsort
    # keeps 2 and 8, then frame 1 before frame 9 of the same |dPA|
    assert annular_ref.library(angles, 5, 2.5, 3).tolist() == [1, 2, 8]
    # the first frame: nothing before it; at most n - 1 frames
    assert annular_ref.library(angles, 0, 0.5).tolist() == list(range(1, 10))
    assert annular_ref.library(angles, 9, 100.0).tolist() == []


def test_threshold_and_its_cap_by_hand():
    angles = np.linspace(0.0, 10.0, 11)           # half the range: 5 deg
    # 2·atan(1·4 / (2·1)) = 126.87 deg, far above 90% of 5 deg
    assert annular_ref.pa_threshold(1.0, 4.0, 1.0, angles) == \
        pytest.approx(126.8698976)
    assert annular_ref.pa_threshold(1.0, 4.0, 1.0, angles,
                                    strict=False) == pytest.approx(4.5)
    small = annular_ref.pa_threshold(50.0, 4.0, 0.5, angles, strict=False)
    assert small == pytest.approx(np.rad2deg(2 * np.arctan(0.02)))


@pytest.mark.parametrize("strict", [True, False])
def test_the_geometry_is_the_ports(strict):
    rng = np.random.default_rng(5)
    angles = np.sort(rng.uniform(0.0, 40.0, 64))
    for y in (32, 33):
        geo = annular_ref.annuli(y, y, 0, 4)
        assert len(geo) == int((y / 2) / 4)
        for ann, (center, pix) in enumerate(geo):
            thr, inner, c = derotation._define_annuli(
                angles, ann, len(geo), 3.34, 0, 4, 0.55, 1, False, strict)
            assert center == c
            assert annular_ref.pa_threshold(center, 3.34, 0.55, angles,
                                            strict) == thr
            yy, xx = shapes.get_annulus_segments((y, y), inner, 4, 1)[0]
            assert pix.tolist() == (yy * y + xx).tolist()
    for thr in (0.3, 2.0, 9.0):
        for frame in range(64):
            for cap in (10, 200):
                assert annular_ref.library(angles, frame, thr, cap).tolist() \
                    == derotation._find_indices_adi(
                        angles, frame, thr, truncate=True,
                        max_frames=cap).tolist()

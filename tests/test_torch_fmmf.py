"""The port's FMMF (``invprob.fmmf``) against vip_tpu, on the CPU at
float64, on the 15x40² fixture of tests/test_invprob_fmmf.py (a companion
at r = 6 px).

- ``fmmf`` with the KLIP and LOCI models, the 'FR' and 'FM' noise
  variances (and 'TE' with KLIP), in the port's serial form (vip_tpu's
  CPU default) against vip_tpu's serial form: 1e-6 of max|ref| (both maps;
  measured ~3e-13).
- The batched form (``VIP_TPU_FMMF_BATCHED=1``: the forward models of all
  pixels a frame at a time, the n x P model frames derotated in chunks)
  against the serial form: 1e-10 of max|ref| (the same arithmetic in
  another order).
- The unit-companion models of an annulus (one batched stamp shift, one
  indexed add) against vip_tpu's ``cube_inject_companions`` of each pixel:
  1e-12; ``KLIP_patch`` and ``_perturb`` against vip_tpu's: 1e-9 (sign-free
  products of the eigenvectors).
- The golden fmmf_kl_adi on one annulus (r = 26; ~8 min on one CPU
  thread) in the slow lane: ≤1e-5 max abs (FRAME_TOL).
"""

import importlib
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch
from conftest import make_adi_cube
from gen_golden import GOLDEN_DIR, input_dataset_cached, invprob_configs
from vip_tpu.fm import cube_inject_companions
from vip_tpu_torch.var.shapes import get_annulus_segments

jf = importlib.import_module("vip_tpu.invprob.fmmf")
tf = importlib.import_module("vip_tpu_torch.invprob.fmmf")

torch.set_num_threads(1)

TOL = 1e-6
FORM_TOL = 1e-10
MODEL_TOL = 1e-12
KLIP_TOL = 1e-9
FRAME_TOL = 1e-5    # tests/test_golden.py:28
PARAM = {"ncomp": 5, "tolerance": 5e-3, "delta_rot": 0.25}


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


def fmmf_data():
    """tests/test_invprob_fmmf.py's cube: 15x40² with a companion at r = 6
    px turning with the angles, and an 11x11 Gaussian PSF of FWHM 4."""
    cube, angs = make_adi_cube(n=15, size=40, rot_amp=60.0)
    yy, xx = np.mgrid[:11, :11]
    psf = np.exp(-((yy - 5) ** 2 + (xx - 5) ** 2) / (2 * (4 / 2.355) ** 2))
    psf /= psf.sum()
    yyf, xxf = np.mgrid[:40, :40]
    for k, a in enumerate(angs):
        th = np.deg2rad(a)
        py = 20 + 6 * np.sin(-th)
        px = 20 + 6 * np.cos(-th)
        cube[k] += 30 * np.exp(-((yyf - py) ** 2 + (xxf - px) ** 2)
                               / (2 * (4 / 2.355) ** 2))
    return cube, angs, psf


@pytest.fixture(scope="module")
def data():
    return fmmf_data()


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _run(module, data, batched, monkeypatch, **kw):
    cube, angs, psf = data
    monkeypatch.setenv("VIP_TPU_FMMF_BATCHED", batched)
    args = dict(fwhm=4.0, crop=5, nproc=1, verbose=False, param=PARAM)
    args.update(kw)
    return module.fmmf(cube=cube.copy(), angle_list=angs.copy(),
                       psf=psf.copy(), **args)


@pytest.mark.parametrize("model,var,window", [
    ("KLIP", "FR", (5, 8)), ("LOCI", "FR", (5, 8)), ("KLIP", "FM", (6, 7)),
    ("LOCI", "FM", (6, 7)), ("KLIP", "TE", (6, 7))])
def test_fmmf_vs_vip_tpu(data, monkeypatch, model, var, window):
    kw = dict(model=model, var=var, min_r=window[0], max_r=window[1])
    ref = _run(jf, data, "0", monkeypatch, **kw)
    got = _run(tf, data, "0", monkeypatch, **kw)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL
    # the companion at r = 6 stands out of the S/N map
    assert float(got[1].max()) > 3


@pytest.mark.parametrize("model", ["KLIP", "LOCI"])
def test_fmmf_batched_equals_serial(data, monkeypatch, model):
    kw = dict(model=model, var="FR", min_r=6, max_r=8)
    serial = _run(tf, data, "0", monkeypatch, **kw)
    batched = _run(tf, data, "1", monkeypatch, **kw)
    for b, s in zip(batched, serial):
        assert _rel(b, s.numpy()) <= FORM_TOL


def test_forms_default_by_device(monkeypatch):
    monkeypatch.delenv("VIP_TPU_FMMF_BATCHED", raising=False)
    assert not tf._fmmf_batched_enabled("cpu")
    assert tf._fmmf_batched_enabled("cuda")
    monkeypatch.setenv("VIP_TPU_FMMF_BATCHED", "1")
    assert tf._fmmf_batched_enabled("cpu")


def test_unit_models_and_klip(data):
    cube, angs, psf = data
    (yy, xx), = get_annulus_segments(cube[0], 6, 1)
    band = get_annulus_segments(cube[0], 6 - 2, 4)[0]
    got = tf._unit_models(cube.shape[1:], psf, angs, yy, xx, band,
                          "vip-fft", torch.device("cpu"), torch.float64)
    for i in (0, len(yy) // 2, len(yy) - 1):
        an_dist = np.sqrt((yy[i] - 20) ** 2 + (xx[i] - 20) ** 2)
        theta = np.degrees(np.arctan2(yy[i] - 20, xx[i] - 20))
        ref = cube_inject_companions(np.zeros_like(cube), psf, angs,
                                     flevel=1, rad_dists=an_dist,
                                     theta=theta, n_branches=1)
        assert _rel(got[i], ref[:, band[0], band[1]]) <= MODEL_TOL
    matrix = cube[:, band[0], band[1]]
    for frame in (0, 7):
        ours = tf.KLIP_patch(frame, matrix, 4, angs, 4, 10.0, 6)
        theirs = jf.KLIP_patch(frame, matrix, 4, angs, 4, 10.0, 6)
        np.testing.assert_allclose(ours[0].numpy(), theirs[0],
                                   rtol=KLIP_TOL)
        for k in (3, 4, 5):
            assert _rel(ours[k], theirs[k]) <= KLIP_TOL
        # the basis up to the signs of its vectors
        assert _rel(ours[2].T @ ours[2], theirs[2].T @ theirs[2]) <= KLIP_TOL
    patches = [tf.KLIP_patch(k, matrix, 4, angs, 4, 10.0, 6)
               for k in range(len(angs))]
    ref_patches = [jf.KLIP_patch(k, matrix, 4, angs, 4, 10.0, 6)
                   for k in range(len(angs))]
    values = got[3]
    for b in (0, 9):
        ours = tf._perturb(b, values, 4, *[[p[i] for p in patches]
                                           for i in (0, 1, 2, 5, 4)],
                           angs, 4, 10.0, 6)
        theirs = jf._perturb(b, values.numpy(), 4,
                             *[[p[i] for p in ref_patches]
                               for i in (0, 1, 2, 5, 4)],
                             angs, 4, 10.0, 6)
        assert _rel(ours, theirs) <= KLIP_TOL


@pytest.mark.slow
def test_golden_fmmf_annulus(monkeypatch):
    if not os.path.exists(os.path.join(GOLDEN_DIR, "meta.npz")):
        pytest.skip("golden snapshots not generated")
    ds = input_dataset_cached()
    kwargs = {n: kw for n, _, kw, _ in invprob_configs(ds)}["fmmf_kl_adi"]
    monkeypatch.setenv("VIP_TPU_FMMF_BATCHED", "0")
    flux, snr = tf.fmmf(cube=ds["cube"].copy(), angle_list=ds["angles"],
                        psf=ds["psfn"], **dict(kwargs, min_r=26, max_r=27))
    (yy, xx), = get_annulus_segments(ds["cube"][0], 26, 1)
    for got, name in ((flux, "fmmf_kl_adi"), (snr, "fmmf_kl_adi_snr")):
        ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
        assert np.abs(got.numpy()[yy, xx] - ref[yy, xx]).max() <= FRAME_TOL

"""The port's fake-companion injection against vip_tpu, on the CPU at
float64.

- ``ops.fft.fourier_shift(_batch)`` on odd and even, square and oblong
  frames, with positive, zero and negative shifts (the odd canvas places
  each frame by the sign of its own shift) and several pad margins:
  1e-10, the same FFTs in another library. ``frame_shift``, ``cube_shift``
  and the crops likewise.
- ``cube_inject_companions`` (3-d and 4-d, with and without a
  transmission, with a radial gradient), ``frame_inject_companion``,
  ``cube_planet_free``: 1e-10 of max(|ref|, 1); ``normalize_psf`` and
  ``collapse_psf_cube`` 1e-8 (they recentre by iterated
  Levenberg-Marquardt fits, whose optima agree to ~1e-10 px).
- ``ops.inject.inject_ladder_adi`` equals the repeated host injection
  (1e-8; it is bit-equal on the CPU), also for stamps over the edge.
- The injection golden (tests/test_golden.py:222): VIP's normalized PSF of
  the NACO replica (meta.npz) from the replica's raw Moffat PSF at 1e-5,
  its FWHM at 1e-3, and the flux-300 / radius-30 injection into the
  replica's geometry against vip_tpu's at 1e-10. The golden test itself
  injects into the replica's raw cube, which needs the reference
  package's real NACO frame; with it present, it runs here at 1e-5 too.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vip_tpu_torch
from conftest import make_adi_cube
from gen_golden import GOLDEN_DIR
from naco_replica import _REAL_FRAME, PLSC, moffat_psf
import vip_tpu.fm as jfm
from vip_tpu.ops import fft as jfft
from vip_tpu.preproc import cosmetics as jcos, recentering as jrec
import vip_tpu_torch.fm as tfm
from vip_tpu_torch.ops import fft as tfft
from vip_tpu_torch.ops.inject import inject_ladder_adi
from vip_tpu_torch.preproc import cosmetics as tcos, recentering as trec

torch.set_num_threads(1)
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / max(
        np.abs(ref).max(), 1.0)


@pytest.fixture(scope="module")
def small():
    cube, angles = make_adi_cube(n=16, size=41)
    psfn = tfm.normalize_psf(moffat_psf(size=21, fwhm=4.0), fwhm=4.0,
                             size=11, verbose=False)
    return cube, angles, psfn


@pytest.mark.parametrize("shape", [(11, 11), (12, 12), (13, 10), (9, 14)])
@pytest.mark.parametrize("npad", [0, 1, 3])
def test_fourier_shift_batch_vs_vip_tpu(shape, npad):
    rng = np.random.default_rng(sum(shape) + npad)
    cube = rng.standard_normal((6,) + shape)
    sy = rng.uniform(-2.5, 2.5, 6)
    sx = rng.uniform(-2.5, 2.5, 6)
    sy[0], sx[1], sy[2], sx[3] = 0.0, -0.0, 1.0, -1.5
    theirs = np.asarray(jfft.fourier_shift_batch(
        jnp.asarray(cube), jnp.asarray(sy), jnp.asarray(sx), npad))
    assert _err(tfft.fourier_shift_batch(cube, sy, sx, npad), theirs) <= TOL
    for i in (0, 3, 5):
        one = np.asarray(jfft.fourier_shift(jnp.asarray(cube[i]), sy[i],
                                            sx[i], npad))
        assert _err(tfft.fourier_shift(cube[i], sy[i], sx[i], npad),
                    one) <= TOL


def test_frame_and_cube_shift_vs_vip_tpu():
    rng = np.random.default_rng(4)
    cube = rng.standard_normal((5, 15, 15))
    sy = np.array([0.3, -1.7, 2.2, 0.0, -0.4])
    sx = np.array([-0.8, 1.1, -2.6, 0.5, 0.0])
    assert _err(trec.frame_shift(cube[0], 1.3, -2.4),
                jrec.frame_shift(cube[0], 1.3, -2.4)) <= TOL
    assert _err(trec.cube_shift(cube, sy, sx),
                jrec.cube_shift(cube, sy, sx)) <= TOL
    with pytest.raises(NotImplementedError):
        trec.frame_shift(cube[0], 1, 1, imlib="opencv")


def test_crops_vs_vip_tpu():
    cube = np.arange(4 * 20 * 20, dtype=float).reshape(4, 20, 20)
    for size, xy, force in ((9, None, False), (10, (8, 11), True),
                            (7, (12, 9), False)):
        kw = dict(xy=xy, force=force, verbose=False)
        np.testing.assert_array_equal(
            tcos.cube_crop_frames(cube, size, **kw),
            jcos.cube_crop_frames(cube, size, **kw))
        np.testing.assert_array_equal(tcos.frame_crop(cube[1], size, **kw),
                                      jcos.frame_crop(cube[1], size, **kw))
    np.testing.assert_array_equal(
        tcos.cube_crop_frames(cube[None], 11, verbose=False),
        jcos.cube_crop_frames(cube[None], 11, verbose=False))


def test_shapes_and_coords_vs_vip_tpu():
    from vip_tpu.var import coords as jco, shapes as jsh
    from vip_tpu_torch.var import coords as tco, shapes as tsh

    frame = np.random.default_rng(1).standard_normal((17, 17))
    for kw in (dict(radius=5), dict(radius=4.5, cy=7, cx=10)):
        for mode in ("mask", "val"):
            np.testing.assert_array_equal(
                tsh.get_circle(frame, mode=mode, **kw),
                jsh.get_circle(frame, mode=mode, **kw))
        got = tsh.get_circle(torch.from_numpy(frame), **kw)
        np.testing.assert_array_equal(got.numpy(),
                                      jsh.get_circle(frame, **kw))
    for args in ((9,), (9, 2.5, 6.0), (frame,)):
        np.testing.assert_array_equal(tco.dist_matrix(*args),
                                      jco.dist_matrix(*args))


@pytest.mark.parametrize("theta", [0.0, 37.5, 200.0])
def test_cube_inject_companions_vs_vip_tpu(small, theta):
    cube, angles, psfn = small
    kw = dict(flevel=50.0, rad_dists=[8.0, 15.5], theta=theta, n_branches=2)
    ours, pos = tfm.cube_inject_companions(cube, psfn, angles,
                                           full_output=True, **kw)
    theirs, jpos = jfm.cube_inject_companions(cube, psfn, angles,
                                              full_output=True, **kw)
    assert _err(ours, theirs) <= TOL
    np.testing.assert_allclose(pos, jpos, atol=1e-12)


@pytest.mark.parametrize("radial_gradient", [False, True])
def test_cube_inject_with_transmission_vs_vip_tpu(small, radial_gradient):
    cube, angles, psfn = small
    trans = np.array([[2.0, 10.0, 30.0], [0.2, 0.6, 0.9]])
    kw = dict(flevel=np.linspace(20, 40, cube.shape[0]), rad_dists=[12.0],
              theta=70.0, transmission=trans,
              radial_gradient=radial_gradient, full_output=True)
    ours = tfm.cube_inject_companions(cube, psfn, angles, **kw)
    theirs = jfm.cube_inject_companions(cube, psfn, angles, **kw)
    assert _err(ours[0], theirs[0]) <= TOL
    if radial_gradient:
        assert _err(ours[2], theirs[2]) <= TOL


def test_cube_inject_4d_vs_vip_tpu(small):
    cube, angles, psfn = small
    cube4 = np.stack([cube[:, :25, :25], 0.5 * cube[:, 1:26, 1:26]])
    psf3 = np.stack([psfn, 0.8 * psfn])
    kw = dict(flevel=[10.0, 20.0], rad_dists=[7.0], theta=15.0)
    assert _err(tfm.cube_inject_companions(cube4, psf3, angles, **kw),
                jfm.cube_inject_companions(cube4, psf3, angles, **kw)) <= TOL


def test_frame_inject_and_planet_free_vs_vip_tpu(small):
    cube, angles, psfn = small
    for arr in (cube[0], cube[:3]):
        assert _err(tfm.frame_inject_companion(arr, psfn, 24.3, 15.6, 10.0),
                    jfm.frame_inject_companion(arr, psfn, 24.3, 15.6,
                                               10.0)) <= TOL
    params = [[12.0, 40.0, 30.0], [17.0, 130.0, 15.0]]
    assert _err(tfm.cube_planet_free(params, cube, angles, psfn),
                jfm.cube_planet_free(params, cube, angles, psfn)) <= TOL


def test_normalize_psf_vs_vip_tpu():
    psf = moffat_psf(size=21, fwhm=4.3)
    psf = np.asarray(tfft.fourier_shift(psf, 0.3, -0.2, 1))   # off-centre
    for kw in (dict(fwhm="fit", size=13), dict(fwhm=4.0, size=12),
               dict(fwhm=4.0, threshold=1e-3, mask_core=4)):
        ours = tfm.normalize_psf(psf, verbose=False, full_output=True, **kw)
        theirs = jfm.normalize_psf(psf, verbose=False, full_output=True,
                                   **kw)
        assert _err(ours[0], theirs[0]) <= 1e-8
        assert abs(ours[1] - theirs[1]) <= 1e-8 * abs(theirs[1])
        assert abs(float(ours[2]) - float(theirs[2])) <= 1e-8
    cube = np.stack([psf, 1.2 * psf, 0.9 * psf])
    assert _err(tfm.normalize_psf(cube, fwhm=4.0, size=13, verbose=False),
                jfm.normalize_psf(cube, fwhm=4.0, size=13,
                                  verbose=False)) <= 1e-8
    assert _err(tfm.collapse_psf_cube(cube, 15, verbose=False),
                jfm.collapse_psf_cube(cube, 15, verbose=False)) <= 1e-8
    with pytest.raises(NotImplementedError):
        tfm.normalize_psf(psf, fwhm=4.0, model="moff", verbose=False)


def test_generate_copies_draws_from_the_generator(small):
    cube, angles, psfn = small
    a = list(tfm.generate_cube_copies_with_injections(
        cube, psfn, angles, 0.1, n_copies=2,
        generator=np.random.default_rng(3)))
    b = list(tfm.generate_cube_copies_with_injections(
        cube, psfn, angles, 0.1, n_copies=2,
        generator=np.random.default_rng(3)))
    for x, y in zip(a, b):
        assert x["dist"] == y["dist"] and x["flux"] == y["flux"]
        np.testing.assert_array_equal(x["cube"], y["cube"])
        ref = tfm.cube_inject_companions(cube, psfn, angles,
                                         flevel=x["flux"],
                                         rad_dists=x["dist"],
                                         theta=x["theta"])
        np.testing.assert_array_equal(x["cube"], ref)
    # without a generator the global state draws, as in vip_tpu
    np.random.seed(5)
    c = next(tfm.generate_cube_copies_with_injections(cube, psfn, angles,
                                                      0.1, n_copies=1))
    np.random.seed(5)
    d = next(jfm.generate_cube_copies_with_injections(cube, psfn, angles,
                                                      0.1, n_copies=1))
    assert c["dist"] == d["dist"] and c["flux"] == d["flux"]
    assert _err(c["cube"], d["cube"]) <= TOL


@pytest.mark.parametrize("ang_deg,rads", [(112.0, [6.0, 11.5, 18.0]),
                                          (3.0, [19.6]), (251.0, [4.0])])
def test_ladder_equals_host_injection(small, ang_deg, rads):
    cube, angles, psfn = small
    fluxes = np.array([40.0, 0.0, 15.0])[:len(rads)]
    got = inject_ladder_adi(torch.from_numpy(cube), psfn, angles, rads,
                            fluxes, np.deg2rad(ang_deg)).numpy()
    host = cube.copy()
    for r, f in zip(rads, fluxes):
        if f:
            host = tfm.cube_inject_companions(host, psfn, angles, flevel=f,
                                              rad_dists=[r], theta=ang_deg)
    assert _err(got, host) <= 1e-8
    # against vip_tpu's device ladder too
    from vip_tpu.ops.inject import inject_ladder_adi as jladder

    theirs = np.asarray(jladder(jnp.asarray(cube), jnp.asarray(psfn),
                                jnp.asarray(angles), jnp.asarray(rads),
                                jnp.asarray(fluxes), np.deg2rad(ang_deg)))
    assert _err(got, theirs) <= 1e-8


def test_injection_golden_psf_and_ladder():
    meta = np.load(os.path.join(GOLDEN_DIR, "meta.npz"))
    psfn, _, fwhm = tfm.normalize_psf(moffat_psf(), fwhm="fit", size=20,
                                      force_odd=False, full_output=True,
                                      verbose=False)
    assert np.abs(psfn - meta["psfn"]).max() <= 1e-5
    assert abs(float(fwhm) - float(meta["fwhm"])) <= 1e-3
    zeros = np.zeros((meta["angles"].shape[0], 101, 101))
    kw = dict(flevel=300.0, rad_dists=30.0, plsc=PLSC, verbose=False)
    ours = tfm.cube_inject_companions(zeros, psfn, meta["angles"], **kw)
    theirs = jfm.cube_inject_companions(zeros, np.asarray(meta["psfn"]),
                                        meta["angles"], **kw)
    assert np.abs(ours - theirs).max() <= 1e-5


@pytest.mark.skipif(not os.path.exists(_REAL_FRAME),
                    reason="the replica's raw cube needs the reference "
                    "package's NACO frame")
def test_golden_injection_parity():
    """tests/test_golden.py:222 through the port."""
    from naco_replica import get_replica

    golden = np.load(os.path.join(GOLDEN_DIR, "inputs.npz"))["cube"]
    cube, angles, psf, _, _ = get_replica()
    psfn = tfm.normalize_psf(psf, fwhm="fit", size=20, force_odd=False,
                             verbose=False)
    mine = tfm.cube_inject_companions(cube.copy(), psfn, angles,
                                      flevel=300.0, rad_dists=30.0,
                                      plsc=PLSC, verbose=False)
    assert np.abs(mine - golden).max() <= 1e-5

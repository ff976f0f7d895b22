"""The port's DFT registration (``ops.registration``) and
``cube_recenter_dft_upsampling`` against vip_tpu, on the CPU at float64.

- ``upsampled_dft`` (one frame, and a batch with per-frame offsets),
  ``dft_registration_batch`` at upsample factors 1, 10 and 100 and
  ``masked_register_translation`` (a frame, and a batch of moving frames
  against one reference): the shifts equal to rounding (1e-12 px; XLA may
  divide by the static factor as a product with its reciprocal). An
  argmax tie takes the first flat index, in the coarse and the upsampled
  peak.
- The batched registration equals the per-frame loop of the port's
  ``dft_registration`` bit for bit.
- ``cube_recenter_dft_upsampling``: plain, with ``subi_size`` (the median
  collapse, then the host Gaussian fit: fitted shifts within 1e-6 px),
  with ``mask`` and with ``log``; frames within 1e-8 of max(|ref|, 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import shift as nd_shift

import vip_tpu_torch
from vip_tpu.ops import registration as jreg
from vip_tpu.preproc import recentering as jrec
from vip_tpu_torch.ops import registration as treg
from vip_tpu_torch.preproc import recentering as trec

SHIFT_TOL = 1e-12
FIT_TOL = 1e-6
FRAME_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _frames(got):
    return got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)


def _close(got, ref, tol=FRAME_TOL):
    ref = np.asarray(ref, dtype=float)
    got = _frames(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def jittered():
    """A speckled reference frame and 6 copies shifted by up to 3 px."""
    rng = np.random.default_rng(11)
    ref = rng.standard_normal((28, 28))
    cube = np.stack([nd_shift(ref, rng.uniform(-3, 3, 2), order=3,
                              mode="wrap") for _ in range(6)])
    return ref, cube + 0.01 * rng.standard_normal(cube.shape)


@pytest.fixture(scope="module")
def star_cube():
    """7 frames of 36² with a Moffat star jittered by up to 1.5 px over
    unit noise, from seed 3."""
    from vip_tpu_torch.var.fit_2d import create_synth_psf

    rng = np.random.default_rng(3)
    out = np.empty((7, 36, 36))
    for i, (dy, dx) in enumerate(rng.uniform(-1.5, 1.5, (7, 2))):
        out[i] = create_synth_psf("moff", (36, 36), amplitude=100,
                                  x_mean=18 + dx, y_mean=18 + dy, fwhm=4) \
            + rng.standard_normal((36, 36))
    return out


def test_upsampled_dft_single_and_batched():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((3, 10, 12)) \
        + 1j * rng.standard_normal((3, 10, 12))
    offs = np.array([[3.0, 4.0], [7.5, 2.0], [0.0, 11.0]])
    for i in range(3):
        ref = np.asarray(jreg.upsampled_dft(jnp.asarray(data[i]), 15, 10,
                                            offs[i]))
        one = treg.upsampled_dft(torch.from_numpy(data[i]), 15, 10, offs[i])
        np.testing.assert_allclose(one.numpy(), ref, rtol=0, atol=1e-12)
    batch = treg.upsampled_dft(torch.from_numpy(data), 15, 10,
                               torch.from_numpy(offs))
    for i in range(3):
        ref = np.asarray(jreg.upsampled_dft(jnp.asarray(data[i]), 15, 10,
                                            offs[i]))
        np.testing.assert_allclose(batch[i].numpy(), ref, rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("u", [1, 10, 100])
def test_dft_registration_batch(jittered, u):
    ref, cube = jittered
    theirs = np.asarray(jreg.dft_registration_batch(
        jnp.asarray(ref), jnp.asarray(cube), u))
    ours = treg.dft_registration_batch(torch.from_numpy(ref),
                                       torch.from_numpy(cube), u)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=SHIFT_TOL)
    # the batch against the port's per-frame call
    rf = torch.fft.fft2(torch.from_numpy(ref))
    loop = torch.stack([treg.dft_registration(
        rf, torch.fft.fft2(torch.from_numpy(f)), u) for f in cube])
    assert torch.equal(ours, loop)


@pytest.mark.parametrize("u", [1, 100])
def test_dft_registration_argmax_tie(u):
    """A constant frame: every pixel of the cross-correlation ties, and so
    does every point of the upsampled region; both peaks take the first
    flat index (the coarse shift 0, the fine one -dftshift / u)."""
    flat = np.ones((16, 16))
    f = jnp.fft.fft2(jnp.asarray(flat))
    theirs = np.asarray(jreg.dft_registration(f, f, u))
    tf = torch.fft.fft2(torch.from_numpy(flat))
    ours = treg.dft_registration(tf, tf, u).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=SHIFT_TOL)
    expect = 0.0 if u == 1 else -np.trunc(np.ceil(1.5 * u) / 2) / u
    np.testing.assert_array_equal(ours, [expect, expect])


def test_masked_register_translation(jittered):
    ref, cube = jittered
    mask = np.zeros(ref.shape, bool)
    mask[4:24, 3:25] = True
    moving_mask = np.ones(ref.shape, bool)
    moving_mask[:2] = False
    batch = treg.masked_register_translation(ref, cube, mask)
    assert isinstance(batch, np.ndarray) and batch.shape == (6, 2)
    for i, frame in enumerate(cube):
        theirs = jreg.masked_register_translation(ref, frame, mask)
        ours = treg.masked_register_translation(ref, frame, mask)
        assert isinstance(ours, np.ndarray) and ours.dtype == float
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(batch[i], theirs)
        np.testing.assert_array_equal(
            treg.masked_register_translation(ref, frame, mask, moving_mask,
                                             overlap_ratio=0.5),
            jreg.masked_register_translation(ref, frame, mask, moving_mask,
                                             overlap_ratio=0.5))


def _recenter(mod, cube, **kw):
    return mod.cube_recenter_dft_upsampling(cube, full_output=True,
                                            verbose=False, plot=False, **kw)


@pytest.mark.parametrize("case", ["plain", "subi_size", "mask", "log"])
def test_cube_recenter_dft_upsampling(star_cube, case):
    cube = star_cube
    kw = {}
    if case == "subi_size":
        kw = dict(subi_size=9, fwhm=4)
    elif case == "mask":
        mask = np.zeros(cube.shape[-2:], bool)
        mask[5:31, 5:31] = True
        kw = dict(mask=mask)
    elif case == "log":
        cube = cube + 50
        kw = dict(log=True, upsample_factor=20)
    theirs = _recenter(jrec, cube, **kw)
    ours = _recenter(trec, cube, **kw)
    assert isinstance(ours[0], torch.Tensor)
    assert isinstance(ours[1], np.ndarray) and isinstance(ours[2],
                                                          np.ndarray)
    tol = FIT_TOL if case == "subi_size" else SHIFT_TOL
    np.testing.assert_allclose(ours[1], theirs[1], rtol=0, atol=tol)
    np.testing.assert_allclose(ours[2], theirs[2], rtol=0, atol=tol)
    _close(ours[0], theirs[0])


def test_recenter_shifts_are_the_per_frame_registration(star_cube):
    """The batched registration of the recentering against the port's
    per-frame ``dft_registration`` loop, and the cube shift against
    ``frame_shift`` frame by frame."""
    cube = torch.from_numpy(star_cube)
    rec, y, x = _recenter(trec, cube, upsample_factor=50)
    rf = torch.fft.fft2(cube[0])
    loop = np.stack([np.zeros(2)] + [treg.dft_registration(
        rf, torch.fft.fft2(f), 50).numpy() for f in cube[1:]])
    np.testing.assert_array_equal(np.stack([y, x], 1), loop)
    for i in range(cube.shape[0]):
        assert torch.equal(rec[i], trec.frame_shift(cube[i], y[i], x[i]))

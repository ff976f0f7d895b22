"""The port's interpolation imlibs against vip_tpu on the CPU: 'opencv' and
'skimage' rotations (vip_tpu calls the sandbox's OpenCV 5.0.0), 'opencv'
and 'ndimage-interp' shifts, 'opencv' rescaling and resampling,
``edge_blend`` and ``ops.fft.rotate_fft_batch``.

vip_tpu hands OpenCV float32 frames for 'opencv' and float64 frames for
'skimage', and OpenCV 5.0.0 computes the two differently
(``vip_tpu_torch/ops/warp.py``). The bounds, each of max(|ref|, 1):

- float64 paths (skimage nearest, bilinear, Lanczos; scipy; the FFT
  paths): 1e-10. The fixed-point paths are bit-equal or within 3e-15.
- OpenCV's float64 cubic ('skimage' bicubic and biquadratic) computes
  with float32 coordinates (6.5e-7 from the port's float64 arithmetic
  about the frame center, 2.8e-6 about an off-grid ``cxy``, measured on
  unit-variance frames) and returns values that no interpolation formula
  gives at the pixels whose 4x4 taps leave the frame (ROADMAP Queue 3):
  held at 1e-5 on the pixels whose taps lie inside the frame.
- float32 paths ('opencv'): OpenCV rounds in float32, the port computes
  in float64 from the same float32 frames. Measured: bilinear 2.9e-5,
  bicubic 6.8e-7, Lanczos 1.4e-6, nearest 0, resize 7.5e-7; held at 1e-4
  (bilinear), 1e-5 (the others).
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

from vip_tpu.ops import fft as jfft
from vip_tpu.preproc import derotation as jder
from vip_tpu.preproc import recentering as jrec
from vip_tpu.preproc import rescaling as jres
from vip_tpu_torch.ops import fft as tfft
from vip_tpu_torch.preproc import derotation as tder
from vip_tpu_torch.preproc import recentering as trec
from vip_tpu_torch.preproc import rescaling as tres

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


F64_TOL = 1e-10
F64_CUBIC_TOL = 1e-5
F32_TOL = {"linear": 1e-4, "cubic": 1e-5, "lanczos4": 1e-5, "nearest": 1e-5}

ROT_INTERP = {"bilinear": "linear", "bicubic": "cubic", "nearneig": "nearest",
              "biquadratic": "cubic", "biquartic": "lanczos4",
              "biquintic": "lanczos4", "lanczos4": "lanczos4"}
ROT_BORDERS = ["constant", "edge", "symmetric", "reflect", "wrap"]
CV_INTERP = {"bilinear": "linear", "bicubic": "cubic", "nearneig": "nearest",
             "lanczos4": "lanczos4"}
SHIFT_BORDERS = ["mirror", "reflect", "wrap", "constant", "nearest"]
SIZES = [24, 25]


def _err(got, ref, keep=None):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    d = np.abs(got - ref)
    if keep is not None:
        d = d[keep]
    return np.nanmax(d) / max(np.nanmax(np.abs(ref)), 1.0)


def _frames(n, size, seed):
    return np.random.default_rng(seed).standard_normal((n, size, size))


def _inner_taps(size, angles, cxy):
    """Pixels of each rotated frame whose 4x4 cubic taps lie inside the
    frame (OpenCV 5.0.0's float64 cubic is held there alone)."""
    keep = []
    yy, xx = np.mgrid[0:size, 0:size]
    for a in np.atleast_1d(angles):
        t = np.deg2rad(a)
        cx, cy = cxy
        # inverse rotation about (cx, cy)
        sx = np.cos(t) * (xx - cx) - np.sin(t) * (yy - cy) + cx
        sy = np.sin(t) * (xx - cx) + np.cos(t) * (yy - cy) + cy
        fx, fy = np.floor(sx), np.floor(sy)
        keep.append((fx >= 2) & (fx <= size - 4) & (fy >= 2)
                    & (fy <= size - 4))
    return np.stack(keep)


def _tol(imlib, interpolation):
    cv = ROT_INTERP[interpolation]
    if imlib == "skimage":
        return F64_CUBIC_TOL if cv == "cubic" else F64_TOL
    return F32_TOL[cv]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("border", ROT_BORDERS)
@pytest.mark.parametrize("interpolation", list(ROT_INTERP))
@pytest.mark.parametrize("imlib", ["opencv", "skimage"])
def test_frame_rotate(imlib, interpolation, border, size):
    fr = _frames(1, size, size)[0]
    kw = dict(imlib=imlib, interpolation=interpolation, border_mode=border)
    ref = jder.frame_rotate(fr, 27.3, **kw)
    got = tder.frame_rotate(fr, 27.3, **kw)
    keep = None
    if imlib == "skimage" and ROT_INTERP[interpolation] == "cubic":
        c = jder.frame_center(fr)[::-1]
        keep = _inner_taps(size, [27.3], c)[0]
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    assert _err(got, ref, keep) <= _tol(imlib, interpolation)


@pytest.mark.parametrize("cxy", [None, (10.3, 13.6)])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("border", ROT_BORDERS)
@pytest.mark.parametrize("interpolation", list(ROT_INTERP))
@pytest.mark.parametrize("imlib", ["opencv", "skimage"])
def test_cube_derotate(imlib, interpolation, border, size, cxy):
    cube = _frames(4, size, size + 1)
    angles = np.array([-60.2, -3.1, 17.75, 133.0])
    kw = dict(imlib=imlib, interpolation=interpolation, border_mode=border,
              cxy=cxy)
    ref = jder.cube_derotate(cube, angles, **kw)
    got = tder.cube_derotate(cube, angles, **kw)
    keep = None
    if imlib == "skimage" and ROT_INTERP[interpolation] == "cubic":
        c = jder.frame_center(cube[0])[::-1] if cxy is None else cxy
        keep = _inner_taps(size, -angles, c)
    assert _err(got, ref, keep) <= _tol(imlib, interpolation)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
def test_cube_derotate_tpu_interp(interpolation, size):
    cube = _frames(5, size, 3)
    cube[1, 2, 3] = np.nan               # NaN rotates as zero in both
    angles = np.linspace(-80, 150, 5)
    kw = dict(imlib="tpu-interp", interpolation=interpolation)
    ref = jder.cube_derotate(cube, angles, **kw)
    assert _err(tder.cube_derotate(cube, angles, **kw), ref) <= 1e-12


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("border", SHIFT_BORDERS)
@pytest.mark.parametrize("interpolation", list(CV_INTERP))
def test_shift_opencv(interpolation, border, size):
    cube = _frames(3, size, 7)
    sy = np.array([0.3, -1.7, 2.45])
    sx = np.array([-0.8, 1.1, -2.6])
    kw = dict(imlib="opencv", interpolation=interpolation,
              border_mode=border)
    tol = F32_TOL[CV_INTERP[interpolation]]
    assert _err(trec.frame_shift(cube[0], 1.3, -2.4, **kw),
                jrec.frame_shift(cube[0], 1.3, -2.4, **kw)) <= tol
    assert _err(trec.cube_shift(cube, sy, sx, **kw),
                jrec.cube_shift(cube, sy, sx, **kw)) <= tol


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("border", SHIFT_BORDERS)
@pytest.mark.parametrize("interpolation", ["nearneig", "bilinear",
                                           "biquadratic", "bicubic",
                                           "biquartic", "lanczos4",
                                           "biquintic"])
def test_shift_ndimage_interp(interpolation, border, size):
    cube = _frames(3, size, 8)
    sy = np.array([0.3, -1.7, 2.45])
    sx = np.array([-0.8, 1.1, -2.6])
    kw = dict(imlib="ndimage-interp", interpolation=interpolation,
              border_mode=border)
    assert _err(trec.frame_shift(cube[0], 1.3, -2.4, **kw),
                jrec.frame_shift(cube[0], 1.3, -2.4, **kw)) <= F64_TOL
    assert _err(trec.cube_shift(cube, sy, sx, **kw),
                jrec.cube_shift(cube, sy, sx, **kw)) <= F64_TOL


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("interpolation", list(CV_INTERP))
def test_frame_rescaling_opencv(interpolation, size):
    fr = _frames(1, size, 9)[0]
    fr[3, 4] = np.nan                    # median-filled, then masked
    for kw in (dict(scale=1.23), dict(scale=0.8),
               dict(scale_y=1.1, scale_x=0.9, ref_xy=(11.2, 12.7))):
        ref = jres.frame_rescaling(fr.copy(), imlib="opencv",
                                   interpolation=interpolation, **kw)
        got = tres.frame_rescaling(fr.copy(), imlib="opencv",
                                   interpolation=interpolation, **kw)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
        assert _err(got, ref) <= F32_TOL[CV_INTERP[interpolation]]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("scale", [0.5, 1.37, 2.0])
@pytest.mark.parametrize("interpolation", list(CV_INTERP))
def test_frame_px_resampling_opencv(interpolation, scale, size):
    fr = _frames(1, size, 10)[0]
    kw = dict(imlib="opencv", interpolation=interpolation)
    ref = jres.frame_px_resampling(fr, scale, **kw)
    got = tres.frame_px_resampling(fr, scale, **kw)
    assert tuple(got.shape) == ref.shape
    assert _err(got, ref) <= 1e-5
    cube = _frames(3, size, 11)
    cube[1, 5, 6] = np.nan
    ref = jres.cube_px_resampling(cube, scale, verbose=False, **kw)
    got = tres.cube_px_resampling(cube, scale, verbose=False, **kw)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert _err(got, ref) <= 1e-5


def test_rescaling_wavelengths_opencv():
    cube = _frames(3, 24, 12)
    scal = np.array([1.0, 1.1, 1.2])
    ref = jres.cube_rescaling_wavelengths(cube, scal, imlib="opencv",
                                          interpolation="bicubic")
    got = tres.cube_rescaling_wavelengths(cube, scal, imlib="opencv",
                                          interpolation="bicubic")
    assert _err(got[0], ref[0]) <= 1e-5 and _err(got[1], ref[1]) <= 1e-5


@pytest.mark.parametrize("size", [32, 33])
def test_rotate_fft_batch(size):
    geom = jder._fft_rotate_geometry(size, size)
    canv = _frames(4, geom[0], 13)
    angles = np.array([12.0, -70.5, 100.0, 200.25])
    ref = jfft.rotate_fft_batch(canv, angles)
    got = tfft.rotate_fft_batch(torch.from_numpy(canv),
                                torch.from_numpy(angles))
    assert _err(got, ref) <= 1e-12


def _blend_case(size, seed):
    fr = _frames(3, size, seed) + 5.0
    fr[:, 2, 3] = np.nan                  # a masked pixel in each frame
    fr[1, 10, 11] = 0.0
    return fr


@pytest.mark.parametrize("interp_zeros", [False, True])
@pytest.mark.parametrize("ker", [1, 0])
@pytest.mark.parametrize("size", [16, 17])
def test_edge_blend_interp(size, ker, interp_zeros):
    cube = _blend_case(size, 14)
    angles = np.array([13.0, -50.0, 97.0])
    kw = dict(edge_blend="interp", interp_zeros=interp_zeros, ker=ker)
    ref = jder.cube_derotate(cube, angles, **kw)
    got = tder.cube_derotate(cube, angles, **kw)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert _err(got, ref) <= F64_TOL
    ref = jder.frame_rotate(cube[0], 21.0, **kw)
    assert _err(tder.frame_rotate(cube[0], 21.0, **kw), ref) <= F64_TOL


@pytest.mark.parametrize("mode", ["noise", "noise+interp"])
@pytest.mark.parametrize("size", [16, 17])
def test_edge_blend_noise_with_vip_tpus_draws(size, mode):
    """vip_tpu draws its ring noise from numpy's global generator, one
    ``np.random.normal`` canvas a frame; the port takes the same standard
    normal draws through ``draws=``."""
    cube = _blend_case(size, 15)
    angles = np.array([13.0, -50.0, 97.0])
    canvas = tder._prepad_placement(size, size)[:2]
    np.random.seed(7)
    ref = jder.cube_derotate(cube, angles, edge_blend=mode)
    np.random.seed(7)
    draws = np.stack([np.random.normal(size=canvas) for _ in range(3)])
    got = tder.cube_derotate(cube, angles, edge_blend=mode, draws=draws)
    assert _err(got, ref) <= F64_TOL
    np.random.seed(8)
    ref = jder.frame_rotate(cube[0], 21.0, edge_blend=mode)
    np.random.seed(8)
    got = tder.frame_rotate(cube[0], 21.0, edge_blend=mode,
                            draws=np.random.normal(size=canvas))
    assert _err(got, ref) <= F64_TOL
    # the default: a torch generator seeded 0, the same canvases each call
    a = tder.cube_derotate(cube, angles, edge_blend=mode)
    b = tder.cube_derotate(cube, angles, edge_blend=mode)
    assert torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isfinite(a[:, 5:8, 5:8]).all())


def test_unknown_names_raise_not_implemented():
    fr = _frames(1, 16, 16)[0]
    with pytest.raises(NotImplementedError, match="interpolation"):
        tder.frame_rotate(fr, 10, imlib="opencv", interpolation="spline")
    with pytest.raises(NotImplementedError, match="border"):
        tder.frame_rotate(fr, 10, imlib="skimage", border_mode="mirror")
    with pytest.raises(NotImplementedError, match="interpolation"):
        trec.frame_shift(fr, 1, 1, imlib="opencv", interpolation="biquintic")


def test_port_imports_no_image_library():
    """vip_tpu_torch computes OpenCV's and scikit-image's semantics
    itself: no module imports cv2 or skimage, not even optionally."""
    import pathlib
    import re

    root = pathlib.Path(vip_tpu_torch.__file__).parent
    pat = re.compile(r"^\s*(import|from)\s+(cv2|skimage)\b", re.M)
    hits = [str(p) for p in root.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []


@pytest.mark.parametrize("radial_gradient", [False, True])
@pytest.mark.parametrize("imlib", ["opencv", "skimage", "ndimage-interp"])
def test_cube_inject_companions_imlibs(imlib, radial_gradient):
    """vip_tpu pairs the shift and rotation imlibs (fakecomp.py:112-121):
    'opencv' shifts and rotates with OpenCV's float32 warp, 'skimage' and
    'ndimage-interp' shift with scipy's spline and rotate with OpenCV's
    float64 warp. The stamp's Lanczos rotation and shifts are held as
    above: float32 paths 1e-5, float64 paths 1e-10."""
    from vip_tpu.fm import fakecomp as jfm
    from vip_tpu_torch.fm import fakecomp as tfm

    rng = np.random.default_rng(17)
    cube = rng.standard_normal((6, 40, 40))
    angles = np.linspace(0, 50, 6)
    yy, xx = np.mgrid[:9, :9]
    psf = np.exp(-((yy - 4) ** 2 + (xx - 4) ** 2) / 4.0)
    kw = dict(flevel=50.0, rad_dists=[8.3, 12.7], theta=33.0, imlib=imlib)
    if radial_gradient:
        kw.update(transmission=np.array([[2.0, 10.0, 30.0],
                                         [0.2, 0.6, 0.9]]),
                  radial_gradient=True, n_branches=1, rad_dists=[12.7])
    ours = tfm.cube_inject_companions(cube, psf, angles, **kw)
    theirs = jfm.cube_inject_companions(cube, psf, angles, **kw)
    tol = 1e-5 if imlib == "opencv" else F64_TOL
    assert _err(ours, theirs) <= tol


@pytest.mark.parametrize("imlib", ["opencv", "skimage"])
def test_fmmf_imlibs(imlib, monkeypatch):
    """``fmmf`` with the interpolating imlibs: its unit-companion stamps
    shift as ``cube_inject_companions`` pairs them, batched, and its
    residuals derotate through the batched warp. Held at 1e-4 of the
    maps' scale (the float32 warps' rounding, carried through the KLIP
    forward model; 'skimage' Lanczos is float64 and lands at ~1e-12)."""
    from test_torch_fmmf import PARAM, fmmf_data, jf, tf

    cube, angs, psf = fmmf_data()
    monkeypatch.setenv("VIP_TPU_FMMF_BATCHED", "0")
    kw = dict(fwhm=4.0, crop=5, nproc=1, verbose=False, param=PARAM,
              model="KLIP", var="FR", min_r=5, max_r=7, imlib=imlib,
              interpolation="lanczos4")
    ref = jf.fmmf(cube=cube.copy(), angle_list=angs.copy(), psf=psf.copy(),
                  **kw)
    got = tf.fmmf(cube=cube.copy(), angle_list=angs.copy(), psf=psf.copy(),
                  **kw)
    tol = 1e-4 if imlib == "opencv" else F64_TOL
    for g, r in zip(got, ref):
        assert _err(g, r) <= tol


@pytest.mark.parametrize("imlib", ["opencv", "skimage"])
def test_negfc_chisquare_imlibs(imlib):
    """NEGFC's χ² with an interpolating imlib: the negative companion is
    injected by ``cube_inject_companions`` ('opencv' warp, or scipy's
    spline shift) and the cube derotated by the batched warp. 'skimage'
    is float64 throughout (1e-10); 'opencv' rounds the stamps and frames
    through OpenCV's float32 warp (held at 1e-4 relative)."""
    from test_torch_negfc_fmerit import FLUX, FWHM, R, THETA, jfm, tfm
    from test_torch_negfc_model import negfc_data

    cube, angles, psfn, _ = negfc_data()
    p = (R + 0.3, THETA - 1.0, FLUX * 1.1)
    kw = dict(imlib=imlib, interpolation="lanczos4")
    ref = jfm.chisquare(p, cube, angles, psfn, FWHM, 4, 1, (R, THETA), 3,
                        **kw)
    got = tfm.chisquare(p, cube, angles, psfn, FWHM, 4, 1, (R, THETA), 3,
                        **kw)
    tol = 1e-4 if imlib == "opencv" else F64_TOL
    assert abs(got - ref) <= tol * abs(ref)


@pytest.mark.parametrize("interpolation", ["nearest", "linear", "cubic",
                                           "lanczos4"])
def test_warp_chunks_are_one_batch(interpolation, monkeypatch):
    """``warp_affine`` in chunks of one frame gives the bits of one batch."""
    from vip_tpu_torch.ops import warp

    cube = torch.from_numpy(_frames(5, 20, 18))
    M = warp.rotation_matrix(9.5, 10.0, np.linspace(-50, 70, 5))
    whole = warp.warp_affine(cube, M, (20, 20), interpolation, "reflect",
                             "float32")
    monkeypatch.setattr(warp, "_CHUNK_BYTES", 1)
    assert torch.equal(warp.warp_affine(cube, M, (20, 20), interpolation,
                                        "reflect", "float32"), whole)

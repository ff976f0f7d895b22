"""The port's ``preproc.rescaling`` against vip_tpu's, on the CPU at
float64.

Both zoom with the same host geometry and the same float32 canvas, then
two float64 FFTs in other libraries (pocketfft through XLA, and torch's):
1e-8 of max(|ref|, 1), the slice's bound. ``find_scal_vector`` is a
Nelder-Mead simplex on those χ² values; its scale factors are held to
1e-6, since a last-digit difference in one χ² can move the simplex by
its own tolerance (``xatol`` 1e-6).
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch
import vip_tpu.preproc.rescaling as jr
import vip_tpu_torch.preproc.rescaling as tr

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """Numpy input runs on the CPU in float64 for this module."""
    vip_tpu_torch.set_device("cpu")


def _err(got, ref):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    return np.abs(got[fin] - ref[fin]).max() / max(np.abs(ref[fin]).max(),
                                                   1.0)


def _frame(size, seed=0):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    c = (size - 1) / 2
    halo = 50 * np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (2 * 6.0 ** 2))
    return halo + gaussian_filter(rng.standard_normal((size, size)), 1.5)


@pytest.mark.parametrize("scale", [1.1, 1.3752, 0.8, 2.0])
@pytest.mark.parametrize("ori_dim", [False, True])
def test_scale_fft(scale, ori_dim):
    fr = _frame(40)
    ref = jr.scale_fft(fr, scale, ori_dim=ori_dim)
    got = tr.scale_fft(fr, scale, ori_dim=ori_dim)
    assert _err(got, ref) < TOL


def test_scale_fft_keeps_the_float32_canvas():
    """vip_tpu's canvas is float32 (rescaling.py:59-62): a float64 frame
    is rounded to float32 before the FFT, and the port does the same."""
    fr = _frame(32) * (1 + 1e-9)
    got = tr.scale_fft(fr, 1.25)
    from_f32 = tr.scale_fft(fr.astype(np.float32).astype(np.float64), 1.25)
    assert torch.equal(got, from_f32)
    assert _err(got, jr.scale_fft(fr, 1.25)) < 1e-12


@pytest.mark.parametrize("scale", [1.2, 0.85])
def test_frame_rescaling_odd_with_nans(scale):
    fr = _frame(41, seed=3)
    fr[5, 7] = np.nan
    fr[30:32, 12] = np.nan
    ref = jr.frame_rescaling(fr.copy(), scale=scale)
    got = tr.frame_rescaling(fr.copy(), scale=scale)
    assert _err(got, ref) < TOL


def test_frame_rescaling_ndimage():
    fr = _frame(33, seed=4)
    ref = jr.frame_rescaling(fr.copy(), scale=1.2, imlib="ndimage",
                             interpolation="bicubic")
    got = tr.frame_rescaling(fr.copy(), scale=1.2, imlib="ndimage",
                             interpolation="bicubic")
    assert _err(got, ref) < TOL


def test_opencv_waits_for_slice_8():
    """'opencv' rescaling is ported: OpenCV's float32 Lanczos warp within
    float32 rounding (test_torch_imlibs.py holds every interpolation)."""
    fr = _frame(16)
    ref = jr.frame_rescaling(fr.copy(), scale=1.1, imlib="opencv")
    got = tr.frame_rescaling(fr.copy(), scale=1.1, imlib="opencv")
    assert _err(got, ref) <= 1e-5


@pytest.mark.parametrize("scale", [1.1, 1.3752, 0.8])
def test_matrix_form_is_the_same_zoom(scale):
    """``scale_fft_matrix`` equals vip_tpu's operator, and applied to a
    frame (float32-exact, as the FFT form's canvas) gives the FFT zoom."""
    R0, g, h = tr.scale_fft_matrix(40, scale)
    jR0, jg, jh = jr.scale_fft_matrix(40, scale)
    for a, b in ((R0, jR0), (g, jg), (h, jh)):
        assert np.abs(a - b).max() < 1e-12
    fr = _frame(40, seed=5).astype(np.float32).astype(np.float64)
    fft_form = tr.scale_fft(fr, scale, ori_dim=True)
    mat = tr.apply_scale_matrix(torch.as_tensor(np.stack([fr, fr])), R0, g, h)
    assert _err(mat[1], fft_form) < TOL
    assert _err(tr.apply_scale_matrix(fr, R0, g, h), fft_form) < TOL


def test_cube_rescaling_groups_equal_scales():
    cube = np.stack([_frame(24, s) for s in range(4)])
    scal = [1.2, 1.0, 1.2, 0.9]
    ref = jr.cube_rescaling(cube, scal)
    got = tr.cube_rescaling(cube, scal)
    assert _err(got, ref) < TOL


@pytest.mark.parametrize("collapse", ["median", "mean"])
def test_cube_rescaling_wavelengths_round_trip(collapse):
    z, size = 5, 30
    cube = np.stack([_frame(size, s) for s in range(z)])
    scal = 1.3 / np.linspace(1.0, 1.3, z)
    ref = jr.cube_rescaling_wavelengths(cube, scal, collapse=collapse)
    got = tr.cube_rescaling_wavelengths(cube, scal, collapse=collapse)
    for a, b in zip(got[:2], ref[:2]):
        assert _err(a, b) < TOL
    assert tuple(got[2:]) == tuple(ref[2:])
    back_ref = jr.cube_rescaling_wavelengths(
        ref[0], scal, inverse=True, y_in=size, x_in=size, collapse=collapse)
    back = tr.cube_rescaling_wavelengths(
        got[0], scal, inverse=True, y_in=size, x_in=size, collapse=collapse)
    for a, b in zip(back[:2], back_ref[:2]):
        assert _err(a, b) < TOL
    assert tuple(back[2:]) == tuple(back_ref[2:])


def test_batched_channels_equal_the_frame_by_frame_calls():
    """``_scwave`` over (z, B, y, x) gives each frame's
    ``cube_rescaling_wavelengths``, in both directions."""
    z, B, size = 4, 3, 20
    cube = np.stack([np.stack([_frame(size, 10 * c + b) for b in range(B)])
                     for c in range(z)])
    scal = 1.25 / np.linspace(1.0, 1.25, z)
    out, frames = tr._scwave(torch.as_tensor(cube), scal)[:2]
    for b in range(B):
        one = tr.cube_rescaling_wavelengths(cube[:, b], scal)
        assert torch.equal(out[:, b], one[0])
        assert torch.equal(frames[b], one[1])
    back = tr._scwave(out, scal, inverse=True, y_in=size, x_in=size)
    for b in range(B):
        one = tr.cube_rescaling_wavelengths(out[:, b], scal, inverse=True,
                                            y_in=size, x_in=size)
        assert torch.equal(back[0][:, b], one[0])
        assert torch.equal(back[1][b], one[1])


def test_reflect_pad_limit():
    cube = np.stack([_frame(10, s) for s in range(2)])
    with pytest.raises(ValueError, match="up to 3"):
        tr.cube_rescaling_wavelengths(cube, [3.5, 1.0])


@pytest.mark.parametrize("nframes", [None, 4])
@pytest.mark.parametrize("index_ref", [0, 5, 11])
def test_find_indices_sdi(index_ref, nframes):
    scal = 1.35 / np.linspace(0.95, 1.35, 12)
    args = (scal, 25.0, index_ref, 4, 0.5, nframes)
    try:
        ref = jr._find_indices_sdi(*args)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            tr._find_indices_sdi(*args)
        return
    assert np.array_equal(tr._find_indices_sdi(*args), ref)


def test_check_scal_vector():
    v = [1.4, 1.2, 2.0]
    assert np.array_equal(tr.check_scal_vector(v), jr.check_scal_vector(v))
    v64 = torch.tensor(v, dtype=torch.float64)
    assert np.array_equal(tr.check_scal_vector(v64),
                          jr.check_scal_vector(np.array(v)))


@pytest.mark.parametrize("nfp", [1, 2])
def test_find_scal_vector(nfp):
    size = 24
    base = _frame(size, seed=6)
    lbdas = np.array([1.0, 1.1, 1.2])
    fluxes = np.array([1.0, 0.9, 0.8])
    cube = np.stack([jr.frame_rescaling(base, scale=lbdas[i] / lbdas[-1])
                     * fluxes[i] for i in range(3)])
    opts = {"xatol": 1e-6, "fatol": 1e-6, "maxiter": 200, "maxfev": 400}
    ref = jr.find_scal_vector(cube, lbdas, fluxes, nfp=nfp, fm="sum",
                              simplex_options=opts)
    got = tr.find_scal_vector(cube, lbdas, fluxes, nfp=nfp, fm="sum",
                              simplex_options=opts)
    assert np.abs(got[0] - ref[0]).max() < 1e-6
    assert np.abs(got[1] - ref[1]).max() < 1e-6


@pytest.mark.parametrize("imlib", ["vip-fft", "ndimage"])
@pytest.mark.parametrize("scale", [2, 0.5])
@pytest.mark.parametrize("size", [20, 21])
def test_cube_px_resampling(imlib, scale, size):
    cube = np.stack([_frame(size, s) for s in range(3)])
    cube[1, 3, 4] = np.nan
    ref = jr.cube_px_resampling(cube, scale, imlib=imlib,
                                interpolation="bicubic", verbose=False)
    got = tr.cube_px_resampling(cube, scale, imlib=imlib,
                                interpolation="bicubic", verbose=False)
    assert _err(got, ref) < TOL
    ref_fr = jr.frame_px_resampling(cube[0], scale, imlib=imlib,
                                    interpolation="bicubic")
    got_fr = tr.frame_px_resampling(cube[0], scale, imlib=imlib,
                                    interpolation="bicubic")
    assert _err(got_fr, ref_fr) < TOL

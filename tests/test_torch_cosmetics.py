"""The port's subsampling, cosmetics and parallactic angles (slice 8a of
``preproc``) against vip_tpu, on the CPU at float64.

- ``cube_subsample`` (every mode, 3-d and 4-d, ``parallactic``, the
  dropped remainder) and ``cube_subsample_trimmean`` (its quirks: a cube
  shorter than a window, a remainder of 0): 1e-10 of max(|ref|, 1).
- ``frame_pad`` (values, noise from a ``torch.Generator``),
  ``cube_drop_frames``, ``frame_remove_stripes``: equal.
- ``cube_correct_nan`` (2-d, 3-d, 4-d, ``half_res_y``, a frame under
  3 px) and ``nan_corr_2d``: equal frames and NaN counts; the sweep counts
  of the batched call equal those of one call a frame.
- ``approx_stellar_position`` with outlier channels: equal.
- ``compute_paral_angles``, ``compute_derot_angles_pa`` and
  ``compute_derot_angles_cd`` (with ``skew`` and ``writing``) from FITS
  files written to ``tmp_path`` with the needed keys: 1e-12.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch
from vip_tpu.preproc import cosmetics as jcos
from vip_tpu.preproc import parangles as jpa
from vip_tpu.preproc import subsampling as jsub
from vip_tpu_torch.fits import write_fits
from vip_tpu_torch.preproc import cosmetics as tcos
from vip_tpu_torch.preproc import parangles as tpa
from vip_tpu_torch.preproc import subsampling as tsub

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=TOL):
    got, ref = _np(got), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, equal_nan=True,
                               atol=tol * max(np.nanmax(np.abs(ref)), 1.0))


@pytest.fixture(scope="module")
def cube():
    c = np.random.default_rng(31).standard_normal((23, 14, 12))
    c[3, 2, 2] = np.nan
    return c


@pytest.mark.parametrize("mode", ("mean", "median", "sum", "max", "absmean",
                                  "trimmean", "wmean"))
def test_cube_subsample_3d(cube, mode):
    pa = np.linspace(0, 40, cube.shape[0])
    w = np.array([0.1, 0.2, 0.3, 0.4]) if mode == "wmean" else None
    ref, ref_pa = jsub.cube_subsample(cube, 4, mode, w=w, parallactic=pa,
                                      verbose=False)
    out, out_pa = tsub.cube_subsample(cube, 4, mode, w=w, parallactic=pa,
                                      verbose=False)
    _close(out, ref)
    _close(out_pa, ref_pa)


@pytest.mark.parametrize("mode", ("mean", "median", "trimmean"))
def test_cube_subsample_4d(mode):
    c4 = np.random.default_rng(2).standard_normal((3, 13, 8, 9))
    _close(tsub.cube_subsample(c4, 3, mode, verbose=False),
           jsub.cube_subsample(c4, 3, mode, verbose=False))


@pytest.mark.parametrize("N,n", ((6, 50), (7, 50), (9, 4), (10, 4)))
def test_cube_collapse_trimmean(N, n):
    """numpy's slice of the sorted frames: when ``n`` is over the frame
    count the trimmed mean is the mean (the port's narrow raised there)."""
    c = np.random.default_rng(N).standard_normal((N, 5, 4))
    _close(tsub.cube_collapse(c, "trimmean", n=n),
           jsub.cube_collapse(c, "trimmean", n=n))


@pytest.mark.parametrize("N,m,n", ((23, 5, 3), (20, 5, 3), (4, 5, 3),
                                   (30, 10, 6)))
def test_cube_subsample_trimmean(N, m, n):
    c = np.random.default_rng(N).standard_normal((N, 7, 6))
    _close(tsub.cube_subsample_trimmean(c, n, m),
           jsub.cube_subsample_trimmean(c, n, m))


@pytest.mark.parametrize("kw", [dict(fac=2), dict(fac=1.5, fillwith=-3.0),
                                dict(fac=(1.3, 2.2), keep_parity=False,
                                     full_output=True)])
def test_frame_pad(cube, kw):
    f = np.nan_to_num(cube[0])
    ref = jcos.frame_pad(f, **kw)
    out = tcos.frame_pad(f, **kw)
    if kw.get("full_output"):
        assert out[1] == ref[1]
        out, ref = out[0], ref[0]
    np.testing.assert_array_equal(_np(out), ref)


def test_frame_pad_noise(cube):
    f = np.nan_to_num(cube[0])
    g = torch.Generator().manual_seed(3)
    out, (y0, y1, x0, x1) = tcos.frame_pad(f, 3, fillwith="noise", loc=5,
                                           scale=0.1, full_output=True,
                                           generator=g)
    _, ref_idx = jcos.frame_pad(f, 3, fillwith="noise", full_output=True)
    assert (y0, y1, x0, x1) == ref_idx
    np.testing.assert_array_equal(out[y0:y1, x0:x1].numpy(), f)
    border = out.clone()
    border[y0:y1, x0:x1] = 5
    assert abs(float(border.mean()) - 5) < 0.02
    again = tcos.frame_pad(f, 3, fillwith="noise", loc=5, scale=0.1,
                           generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, again)


def test_drop_frames_and_stripes(cube):
    pa = np.arange(23.0)
    ref = jcos.cube_drop_frames(cube, 3, 17, parallactic=pa, verbose=False)
    out = tcos.cube_drop_frames(cube, 3, 17, parallactic=pa, verbose=False)
    np.testing.assert_array_equal(_np(out[0]), ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    c4 = np.stack([cube, cube])
    # as vip_tpu, the end index of a 4-d cube is held to its first axis
    np.testing.assert_array_equal(
        _np(tcos.cube_drop_frames(c4, 1, 2, verbose=False)),
        jcos.cube_drop_frames(c4, 1, 2, verbose=False))
    f = np.random.default_rng(1).standard_normal((130, 20))
    _close(tcos.frame_remove_stripes(f), jcos.frame_remove_stripes(f))


def _nan_cube(shape, seed=4):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(shape)
    c[rng.random(shape) < 0.04] = np.nan
    c[..., 4:8, 3:8] = np.nan             # a clump: several sweeps
    c[..., 0, 0] = np.nan
    return c


@pytest.mark.parametrize("shape,half", (((16, 15), False),
                                        ((5, 16, 14), False),
                                        ((5, 16, 14), True),
                                        ((2, 3, 12, 13), False)))
def test_cube_correct_nan(shape, half):
    c = _nan_cube(shape)
    ref = jcos.cube_correct_nan(c, half_res_y=half)
    out = tcos.cube_correct_nan(c, half_res_y=half)
    np.testing.assert_array_equal(_np(out), ref)


def test_correct_nan_sweeps_per_frame():
    c = _nan_cube((6, 16, 14))
    c[2, 4:12, 2:12] = np.nan
    out, nnan, nits = tcos._correct_nan_frames(torch.from_numpy(c), False)
    for i in range(c.shape[0]):
        f, n = tcos.nan_corr_2d(c[i], 3, 3, False, False)
        # vip_tpu corrects a float64 frame in place: give it a copy
        ref, nref = jcos.nan_corr_2d(c[i].copy(), 3, 3, False, False)
        np.testing.assert_array_equal(f.numpy(), ref)
        assert n == nref == int(nnan[i])
        _, nit = tcos._correct_nan_frames(torch.from_numpy(c[i:i + 1]),
                                          False)[1:]
        assert int(nit[0]) == int(nits[i])
    assert int(nits.max()) > int(nits.min())


def test_correct_nan_tiny_frames():
    c = _nan_cube((3, 2, 9), seed=6)
    c[:, :, 4] = 1.0
    np.testing.assert_array_equal(_np(tcos.cube_correct_nan(c)),
                                  jcos.cube_correct_nan(c))


def test_approx_stellar_position():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:41, :41]
    cube = np.empty((12, 41, 41))
    for z in range(12):
        cy, cx = 20 + 0.3 * z / 12, 21 - 0.2 * z / 12
        cube[z] = 100 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8)
    cube += rng.standard_normal(cube.shape)
    cube[3, 5, 5] += 5000                 # outliers: a hot spot
    cube[4, 35:38, 35:38] += 3000
    cube[11, 5:8, 30:33] += 3000
    for kw in (dict(), dict(return_test=True)):
        ref = jcos.approx_stellar_position(cube, 4, **kw)
        out = tcos.approx_stellar_position(cube, 4, **kw)
        for o, r in zip(np.atleast_1d(out) if not kw else out,
                        np.atleast_1d(ref) if not kw else ref):
            np.testing.assert_array_equal(o, r)


HEADER = {"DATE-OBS": "2019-03-12T04:21:07.5", "RA": "05:35:17.3",
          "DEC": "-05:23:28", "LST": "07:51:30.2", "EXPTIME": 12.0}


def test_compute_paral_angles():
    for lat in (-24.627, 19.82):
        _close(tpa.compute_paral_angles(HEADER, lat, "RA", "DEC", "LST",
                                        "EXPTIME"),
               jpa.compute_paral_angles(HEADER, lat, "RA", "DEC", "LST",
                                        "EXPTIME"), 1e-12)


def _write_sequence(tmp_path, keys):
    frame = np.zeros((4, 4), dtype=np.float32)
    for i, k in enumerate(keys):
        write_fits(str(tmp_path / f"obj_{i + 1:03d}.fits"), frame, header=k,
                   verbose=False)


def test_compute_derot_angles_pa(tmp_path):
    rng = np.random.default_rng(8)
    st = np.cumsum(rng.uniform(1, 30, 6)) - 170
    _write_sequence(tmp_path, [{"HIERARCH ESO ADA POSANG": float(s),
                                "HIERARCH ESO ADA POSANG END": float(s + 2)}
                               for s in st])
    kw = dict(digit_format=3, inpath=str(tmp_path) + "/", writing=True,
              outpath=str(tmp_path) + "/")
    out = tpa.compute_derot_angles_pa("obj_", **kw)
    ref = jpa.compute_derot_angles_pa("obj_", **kw)
    _close(out, ref, 1e-12)
    written = np.loadtxt(str(tmp_path / "Parallactic_angles.txt"))
    _close(written, ref, 1e-12)
    _close(tpa.compute_derot_angles_pa("obj_", list_obj=[2, 4], **kw),
           jpa.compute_derot_angles_pa("obj_", list_obj=[2, 4], **kw), 1e-12)


@pytest.mark.parametrize("skew", (False, True))
def test_compute_derot_angles_cd(tmp_path, skew):
    th = np.deg2rad([10.0, 35.0, 80.0, 150.0])
    sk = 0.03 if skew else 0.0
    cd = [{"CD1_1": -np.cos(t), "CD1_2": np.sin(t), "CD2_1": np.sin(t + sk),
           "CD2_2": np.cos(t + sk)} for t in th]
    # the first file's determinant sets the sign for all (east left here)
    cd[0] = {"CD1_1": -1.0, "CD1_2": 0.0, "CD2_1": 0.0, "CD2_2": 1.0}
    _write_sequence(tmp_path, cd)
    kw = dict(inpath=str(tmp_path) + "/", skew=skew, writing=True,
              outpath=str(tmp_path) + "/")
    out = tpa.compute_derot_angles_cd("obj_", **kw)
    ref = jpa.compute_derot_angles_cd("obj_", **kw)
    for o, r in zip(np.atleast_2d(out), np.atleast_2d(ref)):
        _close(o, r, 1e-12)

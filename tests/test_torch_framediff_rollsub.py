"""Port's ``psfsub.frame_diff`` and ``psfsub.roll_sub`` against vip_tpu
on the CPU at float64, the framediff goldens, and the pieces they brought
into the port.

- ``frame_diff`` with the most similar pair and with the median of
  ``n_similar`` frames, after ``pca_annulus``, per metric; ``roll_sub``
  in both modes, with smoothing, a mask and a signal cube: at 1e-10 of
  max(|ref|, 1) (the same float64 differences and FFT rotations).
- The goldens framediff_adi and framediff4_adi (VIP's frames on the NACO
  replica) at ≤1e-5 max abs (tests/test_golden.py:28), and the 3-px
  oracle with the port's own ``detection``.
- The 'skimage' bilinear rotation (OpenCV's float64 ``warpAffine``, which
  the greedy algorithms use for their masks) against vip_tpu's OpenCV
  call, bit for bit; ``cube_filter_lowpass`` against vip_tpu.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

from conftest import make_adi_cube
import vip_tpu.preproc.derotation as jder
import vip_tpu.psfsub as jps
import vip_tpu.var.filters as jfil
import vip_tpu_torch.preproc.derotation as tder
import vip_tpu_torch.psfsub as tps
import vip_tpu_torch.var.filters as tfil
from test_torch_llsg import golden_ds, golden_frame  # noqa: F401

torch.set_num_threads(1)

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _err(got, ref):
    ref = np.asarray(ref)
    return np.abs(got.numpy() - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.fixture(scope="module")
def small():
    return make_adi_cube(n=24, size=41)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_similar=4),
    dict(ncomp=2),
    dict(metric="correlation", n_similar=3),
    dict(metric="euclidean", delta_rot=0, dist_threshold=50),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "pairs")
def test_frame_diff_vs_vip_tpu(small, kw):
    cube, angles = small
    args = dict(fwhm=4, metric="l1", dist_threshold=90, delta_rot=0.5,
                radius_int=4, asize=4, verbose=False)
    args.update(kw)
    ref = jps.frame_diff(cube=cube.copy(), angle_list=angles, **args)
    got = tps.frame_diff(cube=cube.copy(), angle_list=angles, **args)
    assert float(got.abs().max()) > 0
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mode="individual"),
    dict(collapse="median", mode="individual"),
    dict(smooth_ker_bef=2.0, smooth_ker_aft=1.5, mask_rad=3),
    dict(cube_sig=True),
    dict(two_angles=True),
    dict(tuple_of_rolls=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "mean")
def test_roll_sub_vs_vip_tpu(kw):
    cube, _ = make_adi_cube(n=16, size=41)
    angles = np.array([0.0] * 8 + [25.0] * 8)
    kw = dict(kw)
    if kw.pop("cube_sig", False):
        kw["cube_sig"] = 0.01 * cube
    if kw.pop("two_angles", False):
        angles = np.array([0.0, 25.0])
    if kw.pop("tuple_of_rolls", False):
        cube = (cube[:8], cube[8:])
    ref = jps.roll_sub(cube=cube, angle_list=angles, full_output=True,
                       verbose=False, **kw)
    got = tps.roll_sub(cube=cube, angle_list=angles, full_output=True,
                       verbose=False, **kw)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert _err(g, r) <= TOL


@pytest.mark.parametrize("name", ["framediff_adi", "framediff4_adi"])
def test_golden_framediff(golden_ds, name):  # noqa: F811
    golden_frame(golden_ds, name)


@pytest.mark.parametrize("size", [41, 50])
def test_bilinear_rotation_is_vip_tpus_opencv_call(size):
    rng = np.random.default_rng(size)
    masks = (rng.random((15, size, size)) > 0.7).astype(float)
    angles = np.linspace(-30, 70, 15)
    kw = dict(imlib="skimage", interpolation="bilinear")
    np.testing.assert_array_equal(
        tder.cube_derotate(masks, angles, **kw).numpy(),
        jder.cube_derotate(masks, angles, **kw))
    np.testing.assert_array_equal(
        tder.frame_rotate(masks[0], 33.3, **kw).numpy(),
        jder.frame_rotate(masks[0], 33.3, **kw))
    for other in (dict(imlib="skimage", interpolation="lanczos4"),
                  dict(imlib="opencv", interpolation="bilinear")):
        with pytest.raises(NotImplementedError, match="slice 8"):
            tder.cube_derotate(masks, angles, **other)


@pytest.mark.parametrize("kw", [dict(fwhm_size=2.0), dict(mode="median"),
                                dict(mode="psf", psf=True)])
def test_cube_filter_lowpass_vs_vip_tpu(small, kw):
    cube = small[0][:4]
    kw = dict(kw)
    if kw.pop("psf", False):
        yy, xx = np.mgrid[:9, :9]
        kw["psf"] = np.exp(-((yy - 4) ** 2 + (xx - 4) ** 2) / 4.0)
    ref = jfil.cube_filter_lowpass(cube, **kw)
    got = tfil.cube_filter_lowpass(cube, **kw)
    assert _err(got, ref) <= TOL

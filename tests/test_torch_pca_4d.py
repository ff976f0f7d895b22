"""The port's 4-d (ADI+mSDI) PCA paths against vip_tpu, on the CPU at
float64.

Inputs: the ``ifs_cube`` of tests/test_pca_4d.py:10-30 (4 channels x 8
frames x 40², speckles scaled with the wavelength) and a 39-channel
SPHERE-IFS-like case (39 x 2 x 40², YJ band, ``scale_list`` up to 1.42).
Both packages zoom on the same float32 canvas and factor with LAPACK in
float64: 1e-8 of max(|ref|, 1) throughout.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch
import vip_tpu.psfsub as jps
from vip_tpu.preproc.rescaling import frame_rescaling as jrescale
from vip_tpu.psfsub.pca_local import PCA_ANNULAR_Params as JAnnParams
from vip_tpu.psfsub.pca_fullfr import PCA_Params as JParams
from vip_tpu.psfsub.svd import SVDecomposer as JSVD
from vip_tpu_torch import convert
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.psfsub.svd import SVDecomposer as TSVD

torch.set_num_threads(1)

TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """Numpy input runs on the CPU in float64 for this module, with one
    BLAS thread (vip_tpu's LAPACK calls beside other test workers)."""
    vip_tpu_torch.set_device("cpu")
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _ifs(z, n, size, wl, seed=9, rot=40.0, halo=0.0):
    """Speckles that scale radially with λ, a halo and white noise."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    scal = wl[-1] / wl
    speck = gaussian_filter(rng.standard_normal((size, size)), 2.0) * 5
    yy, xx = np.mgrid[:size, :size]
    c = size // 2
    h = halo * np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (2 * 8.0 ** 2))
    cube = np.empty((z, n, size, size))
    for ch in range(z):
        sp = jrescale(speck.copy(), scale=1 / scal[ch])
        for fr in range(n):
            noise = gaussian_filter(rng.standard_normal((size, size)),
                                    1.0) * 0.3
            cube[ch, fr] = h + sp + noise
    return cube, np.linspace(0, rot, n), scal


@pytest.fixture(scope="module")
def ifs_cube():
    return _ifs(4, 8, 40, np.linspace(1.0, 1.3, 4))


@pytest.fixture(scope="module")
def sphere39():
    return _ifs(39, 2, 40, np.linspace(0.95, 1.35, 39), seed=3, rot=15.0,
                halo=30.0)


def _err(got, ref):
    if isinstance(got, torch.Tensor):
        got = got.cpu().numpy()
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    return np.abs(got[fin] - ref[fin]).max() / max(np.abs(ref[fin]).max(),
                                                   1.0)


def _both(fn_j, fn_t, cube, angles, **kw):
    return (fn_j(cube.copy(), angles, verbose=False, **kw),
            fn_t(cube.copy(), angles, verbose=False, **kw))


@pytest.mark.parametrize("kw", [
    dict(ncomp=2, crop_ifs=True),
    dict(ncomp=3, crop_ifs=False, collapse_ifs="median"),
    dict(ncomp=2, ifs_collapse_range=(1, 3), scaling="temp-mean",
         mask_center_px=4),
], ids=["crop", "nocrop-median", "range-scaling-mask"])
def test_single_pass(ifs_cube, kw):
    cube, angles, scal = ifs_cube
    ref, got = _both(jps.pca, tps.pca, cube, angles, scale_list=scal,
                     adimsdi="single", full_output=True, **kw)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


def test_single_pass_39_channels(sphere39):
    cube, angles, scal = sphere39
    ref, got = _both(jps.pca, tps.pca, cube, angles, scale_list=scal,
                     adimsdi="single", ncomp=4)
    assert _err(got, ref) < TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=(2, 2)),
    dict(ncomp=(2, None)),
    dict(ncomp=(None, 3)),
    dict(ncomp=(3, 2), scaling=("temp-mean", None), smooth_first_pass=2,
         mask_center_px=3, collapse_ifs="median"),
    dict(ncomp=(2, 3), source_xy=(28, 20), delta_rot=0.5, fwhm=4,
         min_frames_pca=2),
], ids=["2-2", "skip-adi", "skip-ifs", "scaling-smooth", "source_xy"])
def test_double_pass(ifs_cube, kw):
    cube, angles, scal = ifs_cube
    ref, got = _both(jps.pca, tps.pca, cube, angles, scale_list=scal,
                     adimsdi="double", full_output=True, **kw)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


def test_double_pass_39_channels(sphere39):
    cube, angles, scal = sphere39
    ref, got = _both(jps.pca, tps.pca, cube, angles, scale_list=scal,
                     adimsdi="double", ncomp=(10, 1))
    assert _err(got, ref) < TOL


@pytest.mark.parametrize("strategy", ["RSDI", "ARSDI"])
@pytest.mark.parametrize("adimsdi", ["single", "double"])
def test_reference_cube_4d(ifs_cube, adimsdi, strategy):
    cube, angles, scal = ifs_cube
    ref_cube = _ifs(4, 5, 40, np.linspace(1.0, 1.3, 4), seed=11)[0]
    ncomp = 2 if adimsdi == "single" else (2, 2)
    ref, got = _both(jps.pca, tps.pca, cube, angles, scale_list=scal,
                     adimsdi=adimsdi, ncomp=ncomp, cube_ref=ref_cube,
                     ref_strategy=strategy)
    assert _err(got, ref) < TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=2),
    dict(ncomp=[1, 2, 3, 2], collapse_ifs="median"),
    dict(ncomp=2, source_xy=(22, 14), delta_rot=0.1, fwhm=4),
], ids=["adi", "per-channel-ncomp", "source_xy"])
def test_per_channel_adi(ifs_cube, kw):
    cube, angles, _ = ifs_cube
    if "source_xy" in kw:
        # each channel's pca keeps its default min_frames_pca (10), so
        # this branch needs more frames than the fixture's 8
        cube, angles, _ = _ifs(2, 16, 32, np.linspace(1.0, 1.2, 2), seed=5,
                              rot=60.0)
    if np.isscalar(kw["ncomp"]):
        # vip_tpu's full output stacks the channels' PCs, which raises
        # when the channels' ncomp differ
        ref, got = _both(jps.pca, tps.pca, cube, angles, full_output=True,
                         **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert _err(g, r) < TOL
    ref, got = _both(jps.pca, tps.pca, cube, angles, **kw)
    assert _err(got, ref) < TOL


def test_per_channel_grid(ifs_cube):
    cube, angles, _ = ifs_cube
    ref, got = _both(jps.pca, tps.pca, cube, angles, ncomp=(1, 3),
                     full_output=True)
    assert _err(got[0], ref[0]) < TOL
    assert got[1] == ref[1]
    assert _err(got[2], ref[2]) < TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=(1, 4)),
    dict(ncomp=[1, 3], ifs_collapse_range=(0, 3), crop_ifs=False),
], ids=["range", "list-nocrop"])
def test_single_pass_grid(ifs_cube, kw):
    cube, angles, scal = ifs_cube
    ref, got = _both(jps.pca, tps.pca, cube, angles, scale_list=scal,
                     adimsdi="single", full_output=True, **kw)
    assert _err(got[0], ref[0]) < TOL
    assert list(got[1]) == list(ref[1])


def test_pca_grid_4d_shape(ifs_cube):
    """``pca_grid`` with ``scale_list`` and ``initial_4dshape`` on the
    rescaled z·n frames, called directly."""
    from vip_tpu.preproc.rescaling import cube_rescaling_wavelengths as jsc

    cube, angles, scal = ifs_cube
    z, n = cube.shape[:2]
    from vip_tpu.preproc.cosmetics import cube_crop_frames

    big = np.stack([jsc(cube[:, i], scal)[0] for i in range(n)])
    big = cube_crop_frames(big.reshape(n * z, *big.shape[-2:]), 40,
                           verbose=False)
    kw = dict(range_pcs=(1, 3), scale_list=scal, initial_4dshape=cube.shape,
              verbose=False, full_output=True)
    ref = jps.pca_grid(big, angles, 4, **kw)
    got = tps.pca_grid(big, angles, 4, **kw)
    assert _err(got[0], ref[0]) < TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=2),
    dict(ncomp=[1, 2, 2, 3], collapse_ifs="median"),
    dict(ncomp=2, cube_ref="3d"),
], ids=["scalar", "per-channel", "ref3d"])
def test_pca_annulus_4d(ifs_cube, kw):
    cube, angles, _ = ifs_cube
    kw = dict(kw)
    if kw.get("cube_ref") == "3d":
        kw["cube_ref"] = _ifs(4, 6, 40, np.linspace(1.0, 1.3, 4),
                              seed=12)[0][0]
    ref = jps.pca_annulus(cube, angles, annulus_width=6, r_guess=12, **kw)
    got = tps.pca_annulus(cube, angles, annulus_width=6, r_guess=12, **kw)
    assert _err(got, ref) < TOL


@pytest.mark.parametrize("mode", ["fullfr", "annular"])
def test_svdecomposer_4d(ifs_cube, mode):
    cube, _, scal = ifs_cube
    kw = dict(mode=mode, scale_list=scal, verbose=False)
    if mode == "annular":
        kw.update(inrad=6, outrad=14)
    ref = JSVD(cube, **kw)
    got = TSVD(cube, **kw)
    ref.generate_matrix()
    got.generate_matrix()
    assert _err(got.matrix, ref.matrix) < TOL
    assert tuple(got.cube4dto3d_shape) == tuple(ref.cube4dto3d_shape)
    ref.run()
    got.run()
    assert _err(got.s, ref.s) < TOL
    assert ref.cevr_to_ncomp(0.9) == got.cevr_to_ncomp(0.9)


def _mask_rdi(size):
    yy, xx = np.mgrid[:size, :size]
    r = np.hypot(yy - size // 2, xx - size // 2)
    anchor = (r > 14).astype(float)
    return anchor, np.ones((size, size))


def test_mask_rdi_3d(ifs_cube):
    cube, angles, _ = ifs_cube
    ref_cube = _ifs(4, 6, 40, np.linspace(1.0, 1.3, 4), seed=13)[0][1]
    masks = _mask_rdi(40)
    ref, got = _both(jps.pca, tps.pca, cube[0], angles, ncomp=3,
                     cube_ref=ref_cube, mask_rdi=masks, full_output=True)
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL
    ref, got = _both(jps.pca, tps.pca, cube[0], angles, ncomp=2,
                     cube_ref=ref_cube, mask_rdi=masks[0])
    assert _err(got, ref) < TOL


def test_cube_subtract_sky_pca_with_ref(ifs_cube):
    from vip_tpu.preproc.skysubtraction import cube_subtract_sky_pca as jsky
    from vip_tpu_torch.preproc import cube_subtract_sky_pca as tsky

    cube = ifs_cube[0]
    masks = _mask_rdi(40)
    ref = jsky(cube[0], cube[1], masks, ref_cube=cube[2], ncomp=3,
               full_output=True)
    got = tsky(cube[0], cube[1], masks, ref_cube=cube[2], ncomp=3,
               full_output=True)
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


def test_mask_rdi_double_pass(ifs_cube):
    """The double pass applies ``mask_rdi`` to the rescaled channels, so
    the masks have the rescaled frames' size (52 px for 40 px at 1.3)."""
    cube, angles, scal = ifs_cube
    masks = _mask_rdi(52)
    ref, got = _both(jps.pca, tps.pca, cube, angles, scale_list=scal,
                     adimsdi="double", ncomp=(2, 2), mask_rdi=masks)
    assert _err(got, ref) < TOL


def test_smooth_waits_for_slice_8(ifs_cube):
    """``smooth`` came with slice 8a: a channel's 3-d frame is
    smoothed as vip_tpu smooths it (every branch in
    tests/test_torch_pca_smooth.py)."""
    cube, angles, _ = ifs_cube
    ref, got = _both(jps.pca, tps.pca, cube[0], angles, ncomp=1, smooth=2)
    assert _err(got, ref) < TOL


def test_params_objects_4d(ifs_cube):
    """The same 4-d parameter objects drive both packages."""
    cube, angles, scal = ifs_cube
    jp = JParams(cube=cube, angle_list=angles, scale_list=scal, ncomp=2,
                 adimsdi="single", verbose=False)
    tp = convert.params_from_numpy(jp)
    assert isinstance(tp.scale_list, torch.Tensor)
    assert _err(tps.pca(algo_params=tp), jps.pca(algo_params=jp)) < TOL
    ja = JAnnParams(cube=cube, angle_list=angles, scale_list=scal,
                    ncomp=(1, 1), radius_int=6, asize=6, fwhm=4,
                    delta_sep=0.1, delta_rot=0.3, verbose=False)
    ta = convert.params_from_numpy(ja)
    assert type(ta).__name__ == "PCA_ANNULAR_Params"
    assert _err(tps.pca_annular(algo_params=ta),
                jps.pca_annular(algo_params=ja)) < TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=2),
    dict(ncomp=[1, 2, 2, 1], collapse_ifs="median"),
], ids=["scalar", "per-channel"])
def test_pca_annular_4d_per_channel(ifs_cube, kw):
    cube, angles, _ = ifs_cube
    ref, got = _both(jps.pca_annular, tps.pca_annular, cube, angles,
                     fwhm=4, radius_int=6, asize=6, delta_rot=0.3,
                     full_output=True, **kw)
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


@pytest.mark.parametrize("kw", [
    dict(ncomp=(1, 2), delta_sep=0.1),
    dict(ncomp=(2, None), n_segments=2, delta_sep=0.1),
    dict(ncomp=(1, 1), delta_sep=(0.1, 0.2), ifs_collapse_range=(0, 3),
         scaling="temp-mean"),
], ids=["1-2", "skip-adi", "range"])
def test_pca_annular_4d_sdi(ifs_cube, kw):
    cube, angles, scal = ifs_cube
    ref, got = _both(jps.pca_annular, tps.pca_annular, cube, angles,
                     scale_list=scal, fwhm=4, radius_int=6, asize=6,
                     delta_rot=0.3, full_output=True, **kw)
    for g, r in zip(got, ref):
        assert _err(g, r) < TOL


def test_pca_annular_4d_sdi_reference(ifs_cube):
    cube, angles, scal = ifs_cube
    ref_cube = _ifs(4, 5, 40, np.linspace(1.0, 1.3, 4), seed=14)[0]
    ref, got = _both(jps.pca_annular, tps.pca_annular, cube, angles,
                     scale_list=scal, fwhm=4, radius_int=6, asize=6,
                     delta_sep=0.1, delta_rot=0.3, ncomp=(1, 2),
                     cube_ref=ref_cube)
    assert _err(got, ref) < TOL


def test_pca_annular_4d_39_channels(sphere39):
    cube, angles, scal = sphere39
    ref, got = _both(jps.pca_annular, tps.pca_annular, cube, angles,
                     scale_list=scal, fwhm=4, radius_int=8, asize=6,
                     ncomp=(2, None), delta_sep=0.1)
    assert _err(got, ref) < TOL

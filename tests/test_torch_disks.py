"""The port's disk forward model (slice 9: ``fm.scattered_light_disk``,
``fakedisk``, ``negfd_interp``, ``utils_negfd``, ``negfd_fmerit``,
``negfd_simplex``) against vip_tpu on the CPU at float64, on small disks
(≤ 64², ≤ 12 frames).

Bounds, each of max(|ref|, 1) unless stated:
- the disk image: 1e-10 relative to its peak (the same float64 formulas
  in another library; measured ~1e-14);
- injection, trace, interpolation, ``cube_disk_free``: 1e-10 on the FFT,
  Lanczos and spline routes (float64 both sides);
- ``chisquare_fd`` with the default ``pca``: 1e-7 relative (each package's
  own PCA, as tests/test_torch_pipeline.py holds it), with
  ``median_sub``: 1e-10.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

from vip_tpu.fm import fakedisk as jfd
from vip_tpu.fm import negfd_fmerit as jfm
from vip_tpu.fm import negfd_interp as jni
from vip_tpu.fm import negfd_simplex as jns
from vip_tpu.fm import scattered_light_disk as jsl
from vip_tpu.fm import utils_negfd as jun
from vip_tpu.psfsub.medsub import median_sub as j_median_sub
from vip_tpu_torch.fm import fakedisk as tfd
from vip_tpu_torch.fm import negfd_fmerit as tfm
from vip_tpu_torch.fm import negfd_interp as tni
from vip_tpu_torch.fm import negfd_simplex as tns
from vip_tpu_torch.fm import scattered_light_disk as tsl
from vip_tpu_torch.fm import utils_negfd as tun
from vip_tpu_torch.psfsub.medsub import median_sub as t_median_sub

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    import threadpoolctl

    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


TOL = 1e-10
PCA_TOL = 1e-7


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _err(got, ref):
    got = _np(got).astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.nanmax(np.abs(got - ref)) / max(np.nanmax(np.abs(ref)), 1.0)


def _rel(got, ref):
    got = _np(got).astype(np.float64)
    ref = np.asarray(ref, np.float64)
    return np.nanmax(np.abs(got - ref)) / np.nanmax(np.abs(ref))


DENS = {'name': '2PowerLaws', 'ain': 10, 'aout': -5, 'a': 40, 'e': 0.2,
        'ksi0': 2., 'gamma': 2., 'beta': 1., 'amin': 5., 'dens_at_r0': 1.}
SPFS = {
    "hg": {'name': 'HG', 'g': 0.4, 'polar': False},
    "hg_polar": {'name': 'HG', 'g': -0.3, 'polar': True},
    "dhg": {'name': 'DoubleHG', 'g': [0.6, -0.2], 'weight': 0.7,
            'polar': False},
    "interp": {'name': 'interpolated',
               'phi': np.array([0, 18, 36, 54, 72, 90, 108, 126, 144, 162,
                                180]),
               'spf': np.array([3.58, 0.703, 0.141, 0.0489, 0.0233, 0.0136,
                                0.0091, 0.0069, 0.0056, 0.005, 0.0049])},
    "interp_linear": {'name': 'interpolated', 'kind': 'linear',
                      'phi': np.linspace(0, 180, 10),
                      'spf': np.linspace(2, 0.1, 10)},
    "polar_polynom": {'name': 'HG', 'g': 0.2, 'polar': True,
                      'polar_polynom_coeff': [1e-5, -2e-3, 0.1, 0.2]},
}


def _disks(spf, **kw):
    args = dict(nx=48, ny=48, distance=50., itilt=70., omega=30.,
                pxInArcsec=0.05, pa=25., density_dico=DENS,
                spf_dico=SPFS[spf], xdo=1.5, ydo=-0.5)
    args.update(kw)
    return jsl.ScatteredLightDisk(**args), tsl.ScatteredLightDisk(**args)


@pytest.mark.parametrize("spf", list(SPFS))
def test_scattered_light_disk(spf):
    theirs, ours = _disks(spf)
    ref = theirs.compute_scattered_light(halfNbSlices=12)
    got = ours.compute_scattered_light(halfNbSlices=12)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert np.nanmax(ref) > 0
    assert _rel(got, ref) <= TOL
    np.testing.assert_allclose(ours.get_scattering_angle(),
                               theirs.get_scattering_angle(), atol=1e-12)


def test_scattered_light_disk_flux_max_and_edge_on():
    theirs, ours = _disks("hg", flux_max=3.0, itilt=89.99, nx=40, ny=36)
    ref = theirs.compute_scattered_light(halfNbSlices=10)
    got = ours.compute_scattered_light(halfNbSlices=10)
    assert ours.itilt == theirs.itilt != 89.99          # clamped alike
    assert abs(float(got.max()) - 3.0) < 1e-12
    assert _rel(got, ref) <= TOL
    # float32 on request, within float32 rounding of the float64 map
    f32 = ours.compute_scattered_light(halfNbSlices=10, dtype=torch.float32)
    assert f32.dtype == torch.float32 and _rel(f32, ref) <= 1e-4


def test_disk_classes_alike():
    for spf in SPFS.values():
        cos_phi = np.linspace(-1, 1, 9)
        np.testing.assert_allclose(
            tsl.Phase_function(spf).compute_phase_function_from_cosphi(
                cos_phi),
            jsl.Phase_function(spf).compute_phase_function_from_cosphi(
                cos_phi), rtol=1e-14)
    d_t = tsl.Dust_distribution(DENS)
    d_j = jsl.Dust_distribution(DENS)
    x, y, z = np.meshgrid(np.linspace(-50, 50, 5), np.linspace(-40, 40, 4),
                          [-1.0, 0.5])
    np.testing.assert_allclose(d_t.density_cartesian(x, y, z),
                               d_j.density_cartesian(x, y, z), rtol=1e-14)
    calc_t, calc_j = (d_t.dust_distribution_calc, d_j.dust_distribution_calc)
    for key in ("rmax", "zmax", "apeak", "itiltthreshold", "p", "pmin"):
        assert getattr(calc_t, key) == getattr(calc_j, key)
    with pytest.raises(TypeError):
        tsl.Phase_function({'name': 'Mie'})


def _disk_img(size=40):
    yy, xx = np.mgrid[:size, :size]
    c = size // 2
    r = np.hypot((yy - c) / 0.5, xx - c)
    return np.exp(-((r - 12) / 3.0) ** 2)


@pytest.mark.parametrize("psf", [None, "array", 2.5])
@pytest.mark.parametrize("size", [40, 41])
def test_cube_inject_fakedisk(size, psf):
    disk = _disk_img(size)
    angs = np.linspace(-40, 60, 7)
    if psf == "array":
        yy, xx = np.mgrid[:9, :9]
        psf = 3 * np.exp(-((yy - 4) ** 2 + (xx - 4) ** 2) / 5.0)
    trans = np.array([[0, 5, 10, 30], [0.1, 0.5, 0.9, 1.0]])
    for tr in (None, trans):
        ref = jfd.cube_inject_fakedisk(disk, angs, psf=psf, transmission=tr)
        got = tfd.cube_inject_fakedisk(disk, angs, psf=psf, transmission=tr)
        assert _err(got, ref) <= TOL
    kw = dict(imlib="skimage", interpolation="biquintic")
    assert _err(tfd.cube_inject_fakedisk(disk, angs, **kw),
                jfd.cube_inject_fakedisk(disk, angs, **kw)) <= TOL


@pytest.mark.parametrize("imlib", ["vip-fft", "ndimage-fourier",
                                   "ndimage-interp"])
def test_cube_inject_trace(imlib):
    rng = np.random.default_rng(3)
    cube = rng.standard_normal((5, 36, 36))
    yy, xx = np.mgrid[:7, :7]
    psf = np.exp(-((yy - 3) ** 2 + (xx - 3) ** 2) / 3.0)
    angs = np.linspace(0, 40, 5)
    kw = dict(flevel=20.0, rad_dists=[6.5, 11.2], theta=[10.0, 75.0],
              n_branches=2, imlib=imlib, verbose=False)
    ref = jfd.cube_inject_trace(cube, psf, angs, **kw)
    got = tfd.cube_inject_trace(cube, psf, angs, **kw)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("multispectral", [False, True])
def test_interpolate_model(multispectral):
    rng = np.random.default_rng(0)
    grid = [np.array([1.0, 2.0, 4.0, 8.0]),
            np.array([10.0, 20.0, 40.0, 80.0])]
    shape = (4, 4, 3, 8, 8) if multispectral else (4, 4, 8, 8)
    models = rng.normal(size=shape)
    for params in ((2.5, 25.0), (3.2, 35.0), (2.0, 22.0)):
        for order in (1, -1, 0, (1, -1)):
            ref = jni.interpolate_model(params, grid, models,
                                        interp_order=order,
                                        multispectral=multispectral)
            got = tni.interpolate_model(params, grid, models,
                                        interp_order=order,
                                        multispectral=multispectral)
            assert _err(got, ref) <= 1e-12, (params, order)


def _disk_cube(n=8, size=40, flux=2.0, seed=1):
    rng = np.random.default_rng(seed)
    angs = np.linspace(-30, 30, n)
    disk = _disk_img(size)
    cube = np.asarray(jfd.cube_inject_fakedisk(flux * disk, angs)) \
        + rng.normal(0, 0.01, (n, size, size))
    return cube, angs, disk


@pytest.mark.parametrize("imlibs", [
    dict(),
    dict(imlib="skimage", interpolation="biquintic",
         imlib_sh="ndimage-interp", interpolation_sh="biquintic"),
    dict(imlib="vip-fft", imlib_sh="ndimage-fourier"),
    dict(imlib="opencv", imlib_sh="opencv", imlib_sc="opencv")])
def test_cube_disk_free_3d(imlibs):
    cube, angs, disk = _disk_cube()
    params = (0.4, -0.3, 6.0, 1.05, 1.8)
    ref = jun.cube_disk_free(params, cube, angs, disk, **imlibs)
    got = tun.cube_disk_free(params, cube, angs, disk, **imlibs)
    tol = 1e-5 if imlibs.get("imlib") == "opencv" else TOL
    assert _err(got, ref) <= tol
    w = np.linspace(0.5, 1.5, cube.shape[0])
    ref = jun.cube_disk_free(params, cube, angs, disk, weights=w,
                             psfn=np.ones((3, 3)) / 9)
    got = tun.cube_disk_free(params, cube, angs, disk, weights=w,
                             psfn=np.ones((3, 3)) / 9)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("model_size", [30, 40, 50])
def test_cube_disk_free_4d_and_fov(model_size):
    """A 4-d cube: per-channel shifts, rotations, scales and fluxes (two
    channels share a scale and rescale in one batch), and disk models
    smaller or larger than the field (padded or cropped)."""
    cube, angs, _ = _disk_cube(n=6)
    cube4 = np.stack([cube, 0.5 * cube, 0.8 * cube])
    disk = _disk_img(model_size)
    disk3 = np.stack([disk, 0.9 * disk, 1.1 * disk])
    params = np.array([[0.3, -0.2, 0.0], [0.1, 0.4, -0.3], [5.0, -3.0, 0.0],
                       [1.1, 1.0, 1.1], [1.5, 0.7, 1.2]])
    ref = jun.cube_disk_free(params, cube4, angs, disk3)
    got = tun.cube_disk_free(params, cube4, angs, disk3)
    assert _err(got, ref) <= TOL
    p3 = (0.2, 0.1, 3.0, 1.0, 1.2)
    assert _err(tun.cube_disk_free(p3, cube, angs, disk),
                jun.cube_disk_free(p3, cube, angs, disk)) <= TOL


@pytest.fixture(scope="module")
def negfd_case():
    cube, angs, disk = _disk_cube(n=10, size=40, flux=3.0, seed=2)
    mask = np.zeros((40, 40), dtype=bool)
    mask[10:30, 5:35] = True
    return cube, angs, disk, mask


@pytest.mark.parametrize("fmerit,mu_sigma", [
    ("sum", None), ("stddev", None), ("sum", (0.0, 0.02)),
    ("sum", "maps")])
def test_chisquare_fd_median_sub(negfd_case, fmerit, mu_sigma):
    cube, angs, disk, mask = negfd_case
    if mu_sigma == "maps":
        mu_sigma = (np.full((40, 40), 0.001), np.full((40, 40), 0.03))
    for imlib in ("skimage", "vip-fft"):
        args = ((0.1, -0.2, 1.0, 1.02, 2.5), cube, angs, disk, mask,
                None)
        ref = jfm.chisquare_fd(*args, fmerit=fmerit, mu_sigma=mu_sigma,
                               algo=j_median_sub,
                               algo_options={"verbose": False}, imlib=imlib)
        got = tfm.chisquare_fd(*args, fmerit=fmerit, mu_sigma=mu_sigma,
                               algo=t_median_sub,
                               algo_options={"verbose": False}, imlib=imlib)
        assert isinstance(got, float)
        assert abs(got - ref) <= TOL * abs(ref)


def test_chisquare_fd_pca_forced_and_grid(negfd_case):
    cube, angs, disk, mask = negfd_case
    opts = {"ncomp": 3, "verbose": False}
    # the default algo (each package's pca), forced parameters
    args = ((2.7,), cube, angs, disk, mask, (0.0, 0.0, 0.0, 1.0),
            (1, 1, 1, 1, 0))
    ref = jfm.chisquare_fd(*args, algo_options=opts)
    got = tfm.chisquare_fd(*args, algo_options=opts)
    assert abs(got - ref) <= PCA_TOL * abs(ref)
    # a 1-d grid of models, interpolated in log space
    grid = [np.array([0.5, 1.0, 2.0, 4.0])]
    models = np.stack([disk * g for g in (0.9, 1.0, 1.1, 1.2)])
    p = (1.5, 0.0, 0.0, 0.0, 1.0, 2.0)
    ref = jfm.chisquare_fd(p, cube, angs, models, mask, None,
                           grid_param_list=grid, algo=j_median_sub,
                           algo_options={"verbose": False})
    got = tfm.chisquare_fd(p, cube, angs, models, mask, None,
                           grid_param_list=grid, algo=t_median_sub,
                           algo_options={"verbose": False})
    assert abs(got - ref) <= TOL * abs(ref)
    out = (9.0,) + p[1:]
    assert tfm.chisquare_fd(out, cube, angs, models, mask, None,
                            grid_param_list=grid, algo=t_median_sub,
                            algo_options={"verbose": False}) == np.inf


def test_firstguess_fd_from_coord(negfd_case):
    cube, angs, disk, mask = negfd_case
    kw = dict(f_range=np.geomspace(0.5, 10, 10), algo_options={
        "verbose": False}, verbose=False, full_output=True)
    ref = jns.firstguess_fd_from_coord((0, 0), 0, 1.0, cube, angs, disk,
                                       mask, algo=j_median_sub, **kw)
    got = tns.firstguess_fd_from_coord((0, 0), 0, 1.0, cube, angs, disk,
                                       mask, algo=t_median_sub, **kw)
    assert got[0] == ref[0]
    # chisquare_fd drops residuals that are exactly 0 from its count: one
    # median residual of the 600 masked pixels is 0.0 in vip_tpu and
    # 1.9e-17 here at one flux of the grid, which moves that χ² by 1/ddf
    np.testing.assert_allclose(got[2], ref[2], rtol=1.0 / (600 - 5))


def test_firstguess_fd_recovers_flux(negfd_case):
    """A planted disk of flux 3 (tests/test_fm_negfd.py:69) is found
    within 0.3 by the grid search and a short simplex, with the default
    imlib pair ('skimage' rotation, 'ndimage-interp' shift, biquintic)."""
    cube, angs, disk, mask = negfd_case
    res = tns.firstguess_fd(cube, angs, disk, mask,
                            f_range=np.geomspace(0.5, 10, 12),
                            algo=t_median_sub,
                            algo_options={"verbose": False}, simplex=True,
                            simplex_options={"xatol": 1e-3, "fatol": 1e-4,
                                             "maxiter": 120,
                                             "maxfev": 160},
                            verbose=False)
    x0, y0, th0, sc0, f0 = res
    assert abs(f0 - 3.0) < 0.3
    assert abs(x0) < 1 and abs(y0) < 1
    assert abs(sc0 - 1.0) < 0.1


def test_chisquare_fd_weights_scale_the_frames_once(negfd_case):
    """With temporal ``weights`` vip_tpu multiplies the flux by them and
    hands the per-frame vector to ``cube_disk_free`` as the model's flux,
    which fails to broadcast against the model frame (ROADMAP Queue 3).
    The port scales the injected frames by the weights once, in
    ``cube_disk_free``: its χ² is that of the weighted subtraction."""
    cube, angs, disk, mask = negfd_case
    w = np.linspace(0.8, 1.2, cube.shape[0])
    p = (0.0, 0.0, 0.0, 1.0, 2.5)
    opts = {"verbose": False}
    with pytest.raises(ValueError):
        jfm.chisquare_fd(p, cube, angs, disk, mask, None, algo=j_median_sub,
                         algo_options=opts, weights=w)
    got = tfm.chisquare_fd(p, cube, angs, disk, mask, None,
                           algo=t_median_sub, algo_options=opts, weights=w)
    free = tun.cube_disk_free(p, cube, angs, disk, imlib="skimage",
                              interpolation="biquintic",
                              imlib_sh="ndimage-interp",
                              interpolation_sh="biquintic", weights=w)
    res = t_median_sub(cube=free, angle_list=angs, verbose=False).numpy()
    vals = res[mask]
    vals = vals[vals != 0]
    assert abs(got - np.abs(vals).sum() / (vals.size - 5)) <= 1e-12 * got

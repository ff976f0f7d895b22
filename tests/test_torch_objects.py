"""The port's object layer (``vip_tpu_torch.objects``) against vip_tpu's
on the CPU at float64.

- ``Dataset`` and ``Frame``: the cube, reference cube and PSFs become
  tensors on the device at construction (a tensor stays where it is), the
  angles stay host numpy; each operation's result against vip_tpu's
  object's at 1e-10 of max(|ref|, 1) (the same float64 arithmetic).
- Every PP class and every ``PPPCA`` run mode: each frame against
  vip_tpu's object at TOL = 1e-7 of max(|ref|, 1) (the measured errors
  are ~1e-13: the same float64 calls underneath); ``PPPCA`` classic
  and ``PPMedianSub`` bit-equal to a direct call of the port's function
  (the object only forwards).
- ``convert.dataset_from_numpy``; ``Saveable`` round trips with tensors;
  a ``Dataset`` saved by either package loaded by the other; ``PPResult``
  FITS round trips, also across the packages.
"""

import copy

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

from conftest import make_adi_cube
import vip_tpu.objects as J
import vip_tpu_torch.objects as T
from vip_tpu_torch.config.utils_conf import Saveable
from vip_tpu_torch.convert import dataset_from_numpy

torch.set_num_threads(1)

TOL = 1e-7        # PP frames against vip_tpu, relative to max(|ref|, 1)
OPS_TOL = 1e-10   # Dataset and Frame operations


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _err(got, ref):
    got, ref = np.asarray(_host(got), float), np.asarray(ref, float)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _psf():
    yy, xx = np.mgrid[:13, :13]
    return np.exp(-((yy - 6) ** 2 + (xx - 6) ** 2) / (2 * (4 / 2.355) ** 2))


def _pair(n=12, size=40, rot_amp=60.0, flux=None):
    """The same dataset in both packages, its PSF normalized (and, with
    ``flux``, a companion injected at 10 px)."""
    cube, angs = make_adi_cube(n=n, size=size, rot_amp=rot_amp)
    out = []
    for pkg in (J, T):
        d = pkg.Dataset(cube=cube, angles=angs, psf=_psf(), px_scale=0.0272)
        d.normalize_psf(fit_fwhm=True, verbose=False)
        if flux is not None:
            d.inject_companions(flux, rad_dists=10, theta=0, verbose=False)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def planted():
    """A wider rotation with a companion: the PP classes' dataset."""
    return _pair(n=16, size=40, rot_amp=90.0, flux=60)


def test_dataset_lands_on_the_device(pair):
    dj, dt = pair
    assert isinstance(dt.cube, torch.Tensor) and dt.cube.dtype == torch.float64
    assert dt.cube.device == vip_tpu_torch.get_device()
    assert isinstance(dt.psf, torch.Tensor) and isinstance(dt.psfn,
                                                           torch.Tensor)
    assert isinstance(dt.angles, np.ndarray)
    assert (dt.w, dt.n, dt.y, dt.x) == (dj.w, dj.n, dj.y, dj.x)
    assert dt.fwhm == pytest.approx(dj.fwhm, abs=1e-12)
    assert _err(dt.psfn, dj.psfn) <= OPS_TOL
    assert dt.get_nbytes() == dj.get_nbytes()
    # a tensor stays where it is, without a copy
    cube = torch.zeros((4, 8, 8), dtype=torch.float32)
    ds = T.Dataset(cube=cube, cuberef=cube, angles=np.zeros(4))
    assert ds.cube is cube and ds.cuberef is cube
    with pytest.raises(TypeError):
        T.Dataset(cube=[[1.0]])
    with pytest.raises(ValueError):
        T.Dataset(cube=torch.zeros((8, 8)))
    with pytest.raises(ValueError):
        T.Dataset(cube=cube, angles=np.zeros(3))


def _both(pair, fn):
    dj, dt = (copy.deepcopy(d) for d in pair)
    return fn(dj), fn(dt), dj, dt


OPERATIONS = {
    "crop_frames": lambda d: d.crop_frames(30),
    "subsample": lambda d: d.subsample(2, mode="mean"),
    "derotate": lambda d: d.derotate(),
    "mask_center": lambda d: d.mask_center(6),
    "filter hp": lambda d: d.filter("hp", "median-subt", median_size=5,
                                    verbose=False),
    "filter lp": lambda d: d.filter("lp", "gauss", fwhm_size=3,
                                    verbose=False),
    "drop_frames": lambda d: d.drop_frames(2, 9, verbose=False),
    "inject_companions": lambda d: d.inject_companions(
        30, rad_dists=[8, 12], n_branches=2, theta=20, verbose=False),
    "rescale": lambda d: d.rescale(0.5, imlib="vip-fft", verbose=False),
}


@pytest.mark.parametrize("name", sorted(OPERATIONS))
def test_dataset_operation(pair, name):
    _, _, dj, dt = _both(pair, OPERATIONS[name])
    assert isinstance(dt.cube, torch.Tensor)
    assert _err(dt.cube, dj.cube) <= OPS_TOL
    np.testing.assert_allclose(dt.angles, dj.angles, atol=1e-12)
    assert (dt.n, dt.y, dt.x) == (dj.n, dj.y, dj.x)
    if dj.injections_yx is not None:
        np.testing.assert_allclose(dt.injections_yx, dj.injections_yx,
                                   atol=1e-12)


def test_dataset_collapse_and_stats(pair):
    dj, dt = pair
    fj, ft = dj.collapse("median"), dt.collapse("median")
    assert isinstance(ft, T.Frame) and isinstance(ft.data, torch.Tensor)
    assert _err(ft.data, fj.data) <= OPS_TOL
    kw = dict(region="annulus", annulus_inner_radius=5, annulus_width=5,
              plot=False)
    for a, b in zip(dt.frame_stats(**kw), dj.frame_stats(**kw)):
        assert _err(a, b) <= OPS_TOL
    for a, b in zip(dt.frame_distances(0, plot=False),
                    dj.frame_distances(0, plot=False)):
        assert _err(a, b) <= OPS_TOL


def test_dataset_remove_badframes(pair):
    _, _, dj, dt = _both(pair, lambda d: d.remove_badframes(
        "pxstats", inner_radius=5, width=5, plot=False, verbose=False))
    np.testing.assert_array_equal(dt.good_indices, dj.good_indices)
    assert _err(dt.cube, dj.cube) == 0
    np.testing.assert_array_equal(dt.angles, dj.angles)


def test_dataset_copy_and_load_vectors(pair):
    _, dt = pair
    d2 = dt.copy()
    assert d2.cube is not dt.cube and torch.equal(d2.cube, dt.cube)
    assert dt.copy(deep=False).cube is dt.cube
    d2.load_angles(torch.arange(12.0))
    assert isinstance(d2.angles, np.ndarray) and d2.angles[-1] == 11
    d2.load_wavelengths([1.0, 1.1])
    np.testing.assert_array_equal(d2.wavelengths, [1.0, 1.1])
    with pytest.raises(ValueError):
        d2.load_angles(3)


FRAME_OPS = {
    "crop": lambda f: f.crop(30),
    "shift": lambda f: f.shift(0.5, -0.5),
    "rotate": lambda f: f.rotate(10),
    "filter": lambda f: f.filter("lp", "gauss", fwhm_size=3),
    "rescale": lambda f: f.rescale(0.5),
}


@pytest.mark.parametrize("name", sorted(FRAME_OPS))
def test_frame_operation(pair, name):
    frames = [J.Frame(np.asarray(pair[0].collapse().data), fwhm=4.0),
              T.Frame(pair[1].collapse().data, fwhm=4.0)]
    for f in frames:
        FRAME_OPS[name](f)
    assert _err(frames[1].data, frames[0].data) <= OPS_TOL


def test_frame_center_stats_and_snr(pair):
    fj = J.Frame(np.asarray(pair[0].collapse().data), fwhm=4.0)
    ft = T.Frame(pair[1].collapse().data, fwhm=4.0)
    assert ft.get_center(verbose=False) == fj.get_center(verbose=False)
    kw = dict(region="annulus", annulus_inner_radius=5, annulus_width=5,
              verbose=False, plot=False)
    for a, b in zip(ft.stats(**kw), fj.stats(**kw)):
        assert _err(a, b) <= OPS_TOL
    assert _err(ft.snr((30, 20), verbose=False),
                fj.snr((30, 20), verbose=False)) <= OPS_TOL


def test_frame_detect_blobs_finds_the_companion(planted):
    dj, dt = planted
    obj = T.PCABuilder(dataset=dt, ncomp=4, verbose=False).build()
    obj.run(verbose=False)
    fr = T.Frame(obj.frame_final, fwhm=dt.fwhm)
    fr.detect_blobs(dt.psfn, bkg_sigma=1, snr_thresh=3, plot=False,
                    full_output=False)
    yy, xx = fr.detection_results
    assert any(np.hypot(y - 20, x - 30) <= 3 for y, x in zip(yy, xx))


PCA_RUNS = {
    "classic": dict(ncomp=5),
    "classic grid": dict(ncomp=(1, 4, 1)),
    "classic source": dict(ncomp=4, source_xy=(30, 20), delta_rot=0.5),
    "annular": dict(ncomp=3, asize=4, delta_rot=(0.1, 1)),
    "grid": dict(range_pcs=(1, 5, 1)),
    "grid source": dict(range_pcs=(1, 5, 1), source_xy=(30, 20)),
    "annulus": dict(ncomp=3, annulus_width=6, r_guess=10),
}


@pytest.mark.parametrize("name", sorted(PCA_RUNS))
def test_pppca_runmode(planted, name):
    kw = PCA_RUNS[name]
    runmode = name.split()[0]
    objs = []
    for pkg, d in zip((J, T), planted):
        obj = pkg.PCABuilder(dataset=d, verbose=False, **kw).build()
        obj.run(runmode=runmode, verbose=False)
        objs.append(obj)
    oj, ot = objs
    if runmode == "grid" and "source_xy" not in kw:
        assert _err(ot.final_residuals_cube, oj.final_residuals_cube) <= TOL
        assert list(ot.pc_list) == list(oj.pc_list)
    elif "ncomp" in kw and isinstance(kw["ncomp"], tuple):
        for a, b in zip(ot.frames_final, oj.frames_final):
            assert _err(a, b) <= TOL
    else:
        assert _err(ot.frame_final, oj.frame_final) <= TOL
    if name == "classic":
        for attr in ("pcs", "cube_reconstructed", "cube_residuals",
                     "cube_residuals_der"):
            assert _err(getattr(ot, attr), getattr(oj, attr)) <= TOL


def test_pppca_and_median_forward_bit_equal(pair):
    """The objects only forward: their frames are the direct calls'."""
    from vip_tpu_torch.psfsub import median_sub, pca

    _, dt = pair
    obj = T.PCABuilder(dataset=dt, ncomp=5, verbose=False).build()
    obj.run(verbose=False)
    direct = pca(cube=dt.cube, angle_list=dt.angles, ncomp=5, fwhm=dt.fwhm,
                 full_output=True, verbose=False)
    assert torch.equal(obj.frame_final, direct[0])
    obj = T.MedianBuilder(dataset=dt, verbose=False).build()
    obj.run()
    direct = median_sub(dt.cube, dt.angles, fwhm=dt.fwhm, full_output=True,
                        verbose=False)
    assert torch.equal(obj.frame_final, direct[2])


PP_CLASSES = {
    "median fullfr": ("MedianBuilder", dict(verbose=False), {}),
    "median annular": ("MedianBuilder", dict(mode="annular", asize=4,
                                             delta_rot=0.5, verbose=False),
                       {}),
    "nmf fullframe": ("NMFBuilder", dict(ncomp=3, verbose=False), {}),
    "nmf annular": ("NMFBuilder", dict(ncomp=3, asize=6, radius_int=6,
                                       verbose=False),
                    dict(runmode="annular")),
    "llsg": ("LLSGBuilder", dict(rank=3, verbose=False), {}),
    "loci": ("LOCIBuilder", dict(verbose=False), {}),
    "frame_diff": ("FrameDiffBuilder", dict(verbose=False), {}),
    "andromeda": ("AndroBuilder", dict(oversampling_fact=0.5,
                                       verbose=False), {}),
    "fmmf": ("FMMFBuilder", dict(min_r=9, max_r=10, verbose=False), {}),
}


@pytest.mark.parametrize("name", sorted(PP_CLASSES))
def test_pp_class(planted, name):
    builder, kw, run_kw = PP_CLASSES[name]
    objs = []
    for pkg, d in zip((J, T), planted):
        res = pkg.PPResult()
        obj = getattr(pkg, builder)(dataset=d, results=res, **kw).build()
        obj.run(**run_kw)
        objs.append(obj)
    oj, ot = objs
    assert isinstance(ot.frame_final, torch.Tensor)
    assert np.isfinite(_host(ot.frame_final)).any()
    assert _err(ot.frame_final, oj.frame_final) <= TOL
    if name in ("andromeda", "fmmf"):
        assert _err(ot.snr_map, oj.snr_map) <= TOL
    sj, st = oj.results.sessions, ot.results.sessions
    assert len(st) == len(sj) == 1
    assert st[0].algo_name == sj[0].algo_name
    assert set(st[0].parameters) == set(sj[0].parameters)
    assert not any(isinstance(v, (np.ndarray, torch.Tensor))
                   for v in st[0].parameters.values())


def test_snrmap_significance_and_sessions(planted):
    objs = []
    for pkg, d in zip((J, T), planted):
        obj = pkg.PCABuilder(dataset=d, ncomp=4, results=pkg.PPResult(),
                             verbose=False).build()
        obj.run(verbose=False)
        obj.make_snrmap(approximated=False)
        obj.compute_significance(source_xy=(30, 20))
        objs.append(obj)
    oj, ot = objs
    assert _err(ot.snr_map, oj.snr_map) <= TOL
    assert ot.signf == pytest.approx(oj.signf, rel=1e-9) and ot.signf > 2
    # make_snrmap gave the registered session its S/N map
    assert len(ot.results.sessions) == 1
    assert ot.results.sessions[0].snr_map is ot.snr_map
    assert ot.detection_map is ot.snr_map


def test_dataset_from_numpy(planted):
    dj, dt = planted
    ds = dataset_from_numpy(dj)
    assert isinstance(ds, T.Dataset)
    for name in ("cube", "psf", "psfn"):
        got = getattr(ds, name)
        assert isinstance(got, torch.Tensor)
        assert _err(got, getattr(dj, name)) == 0
    assert ds.cuberef is None and ds.wavelengths is None
    np.testing.assert_array_equal(ds.angles, dj.angles)
    assert (ds.fwhm, ds.px_scale) == (dj.fwhm, dj.px_scale)
    assert ds.injections_yx == list(dj.injections_yx)
    f32 = dataset_from_numpy(dj, dtype=torch.float32)
    assert f32.cube.dtype == torch.float32 and f32.psfn.dtype == torch.float32


class _Holder(Saveable):
    _saved_attributes = ["frame", "counts", "label", "pairs", "missing"]
    _tensor_attributes = ("frame",)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_saveable_round_trip_with_tensors(tmp_path, dtype):
    h = _Holder()
    h.frame = torch.arange(12, dtype=dtype).reshape(3, 4)
    h.counts = np.arange(5)
    h.label = "pca"
    h.pairs = [(1.5, 2.5), (3.0, 4.0)]
    path = h.save(str(tmp_path / "holder"))
    with np.load(path + ".npz", allow_pickle=True) as f:
        # a tensor is written as its host array, with no item marker
        assert f["frame"].dtype == np.dtype(str(dtype).split(".")[1])
        assert "_item_frame" not in f.files and "_item_label" in f.files
    back = _Holder.load(path)
    assert isinstance(back.frame, torch.Tensor) and back.frame.dtype == dtype
    assert torch.equal(back.frame, h.frame)
    np.testing.assert_array_equal(back.counts, h.counts)
    assert back.label == "pca" and back.missing is None
    assert back.pairs == [[1.5, 2.5], [3.0, 4.0]]
    with pytest.raises(RuntimeError):
        T.Dataset.load(path)


@pytest.mark.parametrize("writer", ["vip_tpu", "port"])
def test_dataset_saved_by_one_package_loads_in_the_other(planted, tmp_path,
                                                         writer):
    dj, dt = planted
    path = str(tmp_path / "ds")
    source = dj if writer == "vip_tpu" else dt
    source.save(path)
    reader = T.Dataset if writer == "vip_tpu" else J.Dataset
    back = reader.load(path)
    for name in ("cube", "psf", "psfn"):
        got = getattr(back, name)
        assert isinstance(got, torch.Tensor if reader is T.Dataset
                          else np.ndarray)
        assert _err(got, _host(getattr(source, name))) == 0
    np.testing.assert_array_equal(back.angles, dj.angles)
    assert back.fwhm == dj.fwhm and back.px_scale == dj.px_scale
    assert back.cuberef is None
    assert [list(p) for p in back.injections_yx] == \
        [list(p) for p in dj.injections_yx]
    assert (back.n, back.y, back.x, back.w) == (dj.n, dj.y, dj.x, dj.w)


def _sessions(pkg, d):
    res = pkg.PPResult()
    obj = pkg.MedianBuilder(dataset=d, results=res, verbose=False).build()
    obj.run()
    obj.make_snrmap(approximated=True)
    obj = pkg.PCABuilder(dataset=d, ncomp=3, results=res,
                         verbose=False).build()
    obj.run(verbose=False)
    return res


@pytest.mark.parametrize("writer", ["vip_tpu", "port"])
def test_ppresult_fits_round_trip(planted, tmp_path, writer):
    dj, dt = planted
    res = {"vip_tpu": _sessions(J, dj), "port": _sessions(T, dt)}
    path = str(tmp_path / "sessions.fits")
    res[writer].results_to_fits(path)
    for pkg in (J, T):
        back = pkg.PPResult(load_from_path=path)
        assert len(back.sessions) == 2
        for got, ref in zip(back.sessions, res["vip_tpu"].sessions):
            assert isinstance(got.frame, np.ndarray)
            assert got.algo_name == ref.algo_name
            assert _err(got.frame, np.float32(ref.frame)) <= 1e-6
            if ref.snr_map is None:
                assert got.snr_map is None
            else:
                assert _err(got.snr_map, np.float32(ref.snr_map)) <= 1e-6
        assert back.sessions[1].parameters["ncomp"] == 3


def test_register_session_and_print_parameters(capsys):
    res = T.PPResult()
    frame = torch.ones((4, 4), dtype=torch.float64)
    res.register_session(frame, algo_name="x",
                         params={"a": 1, "t": frame, "n": np.ones(2)})
    assert res.sessions[0].parameters == {"a": 1}
    snr = torch.zeros((4, 4))
    res.register_session(frame.clone(), snr_map=snr)
    assert len(res.sessions) == 1 and res.sessions[0].snr_map is snr
    obj = T.PPMedianSub(verbose=False)
    obj.frame_final = frame
    obj.print_parameters()
    out = capsys.readouterr().out
    assert "frame_final : torch tensor (not shown)" in out
    for pkg in (J, T):
        with pytest.raises(AttributeError, match="not calculated yet"):
            pkg.PPPCA().cube_reconstructed


def test_postproc_errors_and_pickle(planted, tmp_path):
    _, dt = planted
    obj = T.PCABuilder(ncomp=3, verbose=False).build()
    with pytest.raises(AttributeError, match="No dataset"):
        obj.run()
    obj.run(dataset=dt, verbose=False)
    path = str(tmp_path / "obj.pkl")
    obj.save(path)
    import pickle

    with open(path, "rb") as fh:
        back = pickle.load(fh)
    assert torch.equal(back.frame_final, obj.frame_final)
    with pytest.raises(ValueError, match="Invalid run mode"):
        obj.run(runmode="nope", verbose=False)

"""The port's ``metrics.EvalRoc`` against vip_tpu's on the CPU at float64.

One ``np.random.seed`` before each package's ``inject_and_postprocess``
(``cevr=None``: see below) gives both the same draws (the fluxes, then
the positions, in vip_tpu's order): the fluxes, positions and distances
are equal, each registered
object's frames and S/N maps agree at TOL = 1e-7 of max(|ref|, 1) (the
measured errors are ~1e-13), and ``compute_tpr_fps`` gives the same
detections, false positives and binary maps. The port's keyword-only
``rng`` (a ``numpy.random.RandomState``) gives the draws of the global
state seeded alike. With ``cevr=0.9``, vip_tpu's ``PPPCA`` is given a
numpy integer ``ncomp`` and finds no PCA mode (ROADMAP Queue 3); the
port's runs, and equals its run with that ``ncomp`` set by hand.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

from conftest import make_adi_cube
import vip_tpu.metrics.roc as jroc
import vip_tpu.objects as J
import vip_tpu_torch.metrics.roc as troc
import vip_tpu_torch.objects as T
from vip_tpu_torch.fm import normalize_psf

torch.set_num_threads(1)

TOL = 1e-7
THRESHOLDS = [1, 2, 3]


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
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.fixture(scope="module")
def inputs():
    cube, angs = make_adi_cube(n=12, size=50)
    yy, xx = np.mgrid[:13, :13]
    psf = np.exp(-((yy - 6) ** 2 + (xx - 6) ** 2) / (2 * (4 / 2.355) ** 2))
    return cube, angs, normalize_psf(psf, fwhm=4.0, verbose=False)


def _roc(mod, pkg, inputs, dist_flux=("uniform", 40, 60), seed=10,
         ncomp=3, cevr=None, **kwargs):
    cube, angs, psfn = inputs
    ds = pkg.Dataset(cube=cube, angles=angs, psf=psfn, fwhm=4.0,
                     px_scale=0.1)
    roc = mod.EvalRoc(ds, plsc=0.1, n_injections=2, inrad=8, outrad=14,
                      dist_flux=dist_flux)
    roc.add_algo("medsub", pkg.MedianBuilder(dataset=ds, verbose=False)
                 .build(), "-", "b", thresholds=THRESHOLDS)
    roc.add_algo("pca", pkg.PCABuilder(dataset=ds, ncomp=ncomp,
                                       verbose=False).build(), "-", "r",
                 thresholds=THRESHOLDS)
    if seed is not None:
        np.random.seed(seed)
    roc.inject_and_postprocess(cevr=cevr, **kwargs)
    roc.compute_tpr_fps()
    return roc


@pytest.fixture(scope="module")
def both(inputs):
    return _roc(jroc, J, inputs), _roc(troc, T, inputs)


def test_same_draws(both):
    rj, rt = both
    np.testing.assert_array_equal(rt.fluxes, rj.fluxes)
    assert rt.list_xy == rj.list_xy
    np.testing.assert_array_equal(rt.dists, rj.dists)
    np.testing.assert_array_equal(rt.thetas, rj.thetas)


def test_cevr_sets_ncomp(inputs):
    with pytest.raises(RuntimeError, match="No PCA mode"):
        _roc(jroc, J, inputs, cevr=0.9)
    by_cevr = _roc(troc, T, inputs, cevr=0.9)
    assert isinstance(by_cevr.optpcs, np.integer) and by_cevr.optpcs >= 1
    by_hand = _roc(troc, T, inputs, ncomp=int(by_cevr.optpcs))
    for a, b in zip(by_cevr.methods[1]["frames"],
                    by_hand.methods[1]["frames"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", [0, 1], ids=["medsub", "pca"])
def test_frames_and_maps(both, method):
    mj, mt = both[0].methods[method], both[1].methods[method]
    assert len(mt["frames"]) == len(mj["frames"]) == 2
    for key in ("frames", "probmaps"):
        for got, ref in zip(mt[key], mj[key]):
            assert isinstance(got, torch.Tensor)
            assert _err(got, ref) <= TOL
    assert mt["detections"] == mj["detections"]
    assert mt["fps"] == mj["fps"]
    for got, ref in zip(mt["bmaps"], mj["bmaps"]):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("dist_flux", [("normal", 50, 5),
                                       ("skewnormal", 2, 50, 5)],
                         ids=["normal", "skewnormal"])
def test_rng_gives_the_global_draws(inputs, dist_flux):
    seeded = _roc(troc, T, inputs, dist_flux=dist_flux, seed=3)
    ref = _roc(jroc, J, inputs, dist_flux=dist_flux, seed=3)
    np.random.seed(99)          # the global state no longer matters
    drawn = _roc(troc, T, inputs, dist_flux=dist_flux, seed=None,
                 rng=np.random.RandomState(3))
    for roc in (seeded, drawn):
        np.testing.assert_array_equal(roc.fluxes, ref.fluxes)
        assert roc.list_xy == ref.list_xy
        for got, want in zip(roc.methods[0]["frames"],
                             ref.methods[0]["frames"]):
            assert _err(got, want) <= TOL


def test_synthetic_cube_without_theta(inputs):
    cube, angs, psfn = inputs
    rng = np.random.RandomState(5)
    theta = np.random.RandomState(5).randint(0, 360)
    got, x, y = troc._create_synt_cube(cube, psfn, angs, 0.1, 10, 50,
                                       rng=rng)
    ref, xr, yr = jroc._create_synt_cube(cube, psfn, angs, 0.1, 10, 50,
                                         theta=theta)
    assert (x, y) == (xr, yr)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("npix", [1, 3])
def test_binary_maps_of_many_blobs(npix):
    """``compute_binary_map`` on a noise S/N map of hundreds of blobs (the
    port compares each blob in its bounding box): vip_tpu's counts and
    maps."""
    from scipy.ndimage import gaussian_filter

    frame = gaussian_filter(np.random.default_rng(12).standard_normal(
        (160, 160)), 1.5)
    frame /= frame.std()
    yy, xx = np.mgrid[:160, :160]               # a source at (x, y) (100, 80)
    frame += 6.0 * np.exp(-((yy - 80) ** 2 + (xx - 100) ** 2) / 8.0)
    inj = [(100, 80), (40, 120)]
    ours = troc.compute_binary_map(frame, [0.5, 1, 2, 3], inj, 4.0,
                                   npix=npix)
    theirs = jroc.compute_binary_map(frame, [0.5, 1, 2, 3], inj, 4.0,
                                     npix=npix)
    assert ours[0] == theirs[0] and ours[1] == theirs[1]
    assert ours[0][-1] == 1 and max(ours[1]) > 50
    for a, b in zip(ours[2], theirs[2]):
        np.testing.assert_array_equal(a, b)

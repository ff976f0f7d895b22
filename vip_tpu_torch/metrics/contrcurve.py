"""Contrast curves, throughput and the noise of annuli (port of
``vip_tpu.metrics.contrcurve``).

``algo`` stays a black-box callable, as in VIP. When it is the port's own
full-frame ``psfsub.pca`` with parameters that ``ops.pipeline.
pca_adi_pipeline`` takes (an int ``ncomp``, an SVD mode, a collapse,
'vip-fft' or 'vip-fft-small'), the injected patterns are built on the
cube's device and reduced there, one after another: the base cube crosses
to the device once, each pattern's cube is injected from it by
``ops.inject.inject_ladder_adi`` and reduced by ``pca_adi_pipeline``
(CUDA kernels H2 and H1 on the card), and the reduction without
companions runs through the same reducer with a ladder of zero flux.
vip_tpu stacked the patterns under one ``jax.vmap``; here it is a loop.
Other algos run once per pattern on host cubes.

Photometry runs batched on the device (``ops.apertures``); the frames it
measures and the curves are host numpy. ``_contrast_curve`` computes the
columns of the contrast curve as a dict of numpy arrays, without pandas;
``contrast_curve`` wraps them in vip_tpu's ``DataFrame``.

A 4-d (IFS) cube, with a 3-d PSF (one frame a channel), follows
vip_tpu's 4-d branch: each pattern's companions are injected on the host
by ``fm.cube_inject_companions`` (4-d), the azimuth stepping with the
radius, and each injected cube is reduced by the 4-d algo (the port's
``pca`` with ``scale_list``, or any other); the injected flux is the
mean over the channels of each channel's aperture.

With ``pattern_mesh`` (a 1-D mesh, ``config.frame_mesh``) the patterns
are laid over the mesh's ranks, as vip_tpu lays them over its devices:
on the device route above each rank injects and reduces its share of
the ladders; otherwise the patterns are built on the host and reduced by
``metrics.sharded.sharded_pattern_frames`` (vip_tpu's route, which
builds host cubes a companion at a time: 41.2 s for phase 12's 3
patterns of 1000x512² on an H100 80GB HBM3 at 700 W) when ``algo`` and
its parameters qualify (the port's ``pca`` with pipeline parameters and
no scaling), and vip_tpu's "not shardable" route runs them as without a
mesh.
"""

from enum import Enum
from inspect import getfullargspec

import numpy as np
from scipy import stats
from scipy.interpolate import InterpolatedUnivariateSpline
from scipy.signal import savgol_filter

from ..config import time_ini, timing
from ..config.device import as_tensor
from ..fm.fakecomp import (_extend_transmission, _host,
                           cube_inject_companions, frame_inject_companion,
                           normalize_psf)
from ..ops.apertures import aperture_flux as _aperture_flux_device
from ..ops.apertures import aperture_flux_images
from ..var.coords import dist, frame_center
from ..var.shapes import disk_coords

__all__ = ["contrast_curve", "throughput", "noise_per_annulus",
           "aperture_flux"]


def _value(v):
    return v.value if isinstance(v, Enum) else v


def aperture_flux(array, yc, xc, fwhm, ap_factor=1, mean=False,
                  verbose=False):
    """Sum (or mean) of the pixels in circular apertures of diameter
    ``ap_factor * fwhm`` at (yc, xc) (vip_tpu contrcurve.py:29): exact
    overlap photometry on the frame's device, host numpy out."""
    yc = np.asarray(yc, dtype=float).reshape(-1)
    xc = np.asarray(xc, dtype=float).reshape(-1)
    if mean:
        array = _host(array)
        flux = np.zeros(len(yc))
        for i, (y, x) in enumerate(zip(yc, xc)):
            ind = disk_coords((y, x), (ap_factor * fwhm) / 2, array.shape)
            flux[i] = np.mean(array[ind])
        return flux
    flux = _host(_aperture_flux_device(array, yc, xc, (ap_factor * fwhm) / 2))
    if verbose:
        for i in range(len(yc)):
            print(f"Coordinates of object {i} : ({yc[i]},{xc[i]})")
            print(f"Object Flux = {flux[i]:.2f}")
    return flux


def noise_per_annulus(array, separation, fwhm, init_rad=None, wedge=(0, 360),
                      verbose=False, debug=False):
    """Standard deviation and mean of the fluxes of FWHM apertures along
    annuli ``separation`` px apart (vip_tpu contrcurve.py:51): every
    annulus's apertures in one batched photometry on the frame's device.
    Returns host (noise, res_level, vector_radd)."""
    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array")
    if not isinstance(wedge, tuple):
        raise TypeError("Wedge must be a tuple with the initial and final "
                        "angles")

    def find_coords(rad, sep, init_angle, fin_angle):
        angular_range = fin_angle - init_angle
        npoints = (np.deg2rad(angular_range) * rad) / sep
        ang_step = angular_range / npoints
        i = np.arange(int(npoints))
        x = rad * np.cos(np.deg2rad(ang_step * i + init_angle))
        y = rad * np.sin(np.deg2rad(ang_step * i + init_angle))
        return y, x

    if init_rad is None:
        init_rad = fwhm
    init_angle, fin_angle = wedge
    centery, centerx = frame_center(array)
    n_annuli = int(np.floor((centery - init_rad) / separation)) - 1
    if verbose:
        print(f"{n_annuli} annuli")
    ys_all, xs_all, counts, vector_radd = [], [], [], []
    for i in range(n_annuli):
        y = centery + init_rad + separation * i
        rad = dist(centery, centerx, y, centerx)
        yy, xx = find_coords(rad, fwhm, init_angle, fin_angle)
        ys_all.append(yy + centery)
        xs_all.append(xx + centerx)
        counts.append(yy.shape[0])
        vector_radd.append(rad)
    if n_annuli <= 0:
        return np.array([]), np.array([]), np.array(vector_radd)

    fluxes_all = _host(_aperture_flux_device(
        array, np.concatenate(ys_all), np.concatenate(xs_all), fwhm / 2))
    if debug:
        import matplotlib.pyplot as plt

        _, dbg_ax = plt.subplots(figsize=(6, 6))
        dbg_ax.imshow(_host(array), origin="lower", interpolation="nearest",
                      alpha=0.5, cmap="gray")
    noise, res_level = [], []
    pos = 0
    for i in range(n_annuli):
        fluxes = fluxes_all[pos:pos + counts[i]]
        pos += counts[i]
        noise.append(np.std(fluxes))
        res_level.append(np.mean(fluxes))
        if debug:
            for yj, xj in zip(ys_all[i], xs_all[i]):
                dbg_ax.add_patch(plt.Circle((xj, yj), radius=fwhm / 2,
                                            color="r", fill=False,
                                            alpha=0.8))
        if verbose:
            print(f"Radius(px) = {vector_radd[i]}, Noise = {noise[-1]:.3f} ")
    return np.array(noise), np.array(res_level), np.array(vector_radd)


def _check_algo(algo, algo_class):
    """The parameter names of ``algo``: its own arguments, or the fields
    of its ``<NAME>_Params`` dataclass when it takes ``*args, **kwargs``
    (the port's ``pca`` and ``median_sub``; vip_tpu contrcurve.py:130)."""
    argl = getfullargspec(algo).args
    if "cube" in argl and "angle_list" in argl and "verbose" in argl:
        return argl
    algo_name = algo.__name__
    idx = algo.__module__.index(".", algo.__module__.index(".") + 1)
    mod = algo.__module__[:idx]
    tmp = __import__(mod, fromlist=[algo_name.upper() + "_Params"])
    algo_params = getattr(tmp, algo_name.upper() + "_Params")
    argl = [attr for attr in dir(algo_params)]
    if "cube" in argl and "angle_list" in argl and "verbose" in argl:
        return argl
    raise TypeError("Ineligible algo for contrast curve function. algo "
                    "should have parameters 'cube', 'angle_list' and "
                    "'verbose'")


_BATCHABLE_PCA_KEYS = {"ncomp", "scaling", "collapse", "svd_mode", "imlib",
                       "nproc", "interpolation"}


def _parse_batchable_pca(cube_shape, algo, algo_dict):
    """The ``pca_adi_pipeline`` parameters of ``algo(**algo_dict)`` when
    ``algo`` is the port's own ``psfsub.pca`` (tested by identity: the
    names of both packages start with "vip_tpu") with parameters the
    pipeline takes (vip_tpu contrcurve.py:204); None otherwise."""
    from ..psfsub.pca_fullfr import pca
    from ..psfsub.svd import MODE_TO_METHOD

    if algo is not pca or len(cube_shape) != 3:
        return None
    if not set(algo_dict) <= _BATCHABLE_PCA_KEYS:
        return None
    ncomp = algo_dict.get("ncomp", 1)
    if not isinstance(ncomp, (int, np.integer)):
        return None
    method = MODE_TO_METHOD.get(str(_value(algo_dict.get("svd_mode",
                                                         "lapack"))))
    if method is None:
        return None
    imlib = _value(algo_dict.get("imlib", "vip-fft"))
    if imlib not in ("vip-fft", "vip-fft-small"):
        return None
    rot_mode = "fft-small" if imlib == "vip-fft-small" else "fft"
    ny, nx = cube_shape[-2:]
    if rot_mode == "fft-small" and (nx % 2 != 0 or ny != nx):
        rot_mode = "fft"   # the even-square guard of cube_derotate
    return dict(ncomp=int(ncomp), method=method,
                collapse=str(_value(algo_dict.get("collapse", "median"))),
                rot_mode=rot_mode, scaling=_value(algo_dict.get("scaling")))


def _pattern_reducer(cube_shape, itemsize, parsed):
    """``pca_adi_pipeline`` with ``parsed``'s parameters, derotating in
    the chunks ``psfsub.pca`` takes (``cube_derotate``'s 'auto'), so that
    a pattern's frame is the one ``pca`` gives for the same cube."""
    from ..ops.pipeline import pca_adi_pipeline
    from ..preproc.derotation import _auto_chunk

    n, sz = cube_shape[0], cube_shape[-1]
    chunk = _auto_chunk(n, sz, itemsize)
    if parsed["rot_mode"] == "fft-small":
        chunk = min(n, max(1, 4 * chunk))

    def reduce(cube_fc, angs):
        return pca_adi_pipeline(cube_fc, angs, ncomp=parsed["ncomp"],
                                method=parsed["method"],
                                collapse=parsed["collapse"],
                                scaling=parsed["scaling"], chunk=chunk,
                                rot_mode=parsed["rot_mode"])
    return reduce


def _batched_pca_frames(cubes_fc, parangles, algo, algo_dict):
    """Host pattern cubes, each moved to the default device and reduced
    by ``pca_adi_pipeline`` (vip_tpu contrcurve.py:250). Host frames, or
    None when the algo or its parameters do not qualify."""
    parsed = _parse_batchable_pca(tuple(cubes_fc[0].shape), algo, algo_dict)
    if parsed is None:
        return None
    outs = []
    for cube_fc in cubes_fc:
        cube_fc = as_tensor(cube_fc)
        reduce = _pattern_reducer(tuple(cube_fc.shape),
                                  cube_fc.element_size(), parsed)
        angs = as_tensor(np.asarray(parangles, float), cube_fc.device,
                         cube_fc.dtype)
        outs.append(_host(reduce(cube_fc, angs)))
    return outs


def _batched_pca_frames_lazy(base_cube, psf_stamp, parangles, specs, algo,
                             algo_dict):
    """Every pattern injected on the device from the base cube and
    reduced there (vip_tpu contrcurve.py:295): ``specs`` is a list of
    (rads, fluxes, azimuth [rad]) ladders. The base cube moves to the
    default device once (a tensor stays on its own). Host frames, or None
    when the algo or its parameters do not qualify."""
    from ..ops.inject import inject_ladder_adi

    parsed = _parse_batchable_pca(tuple(base_cube.shape), algo, algo_dict)
    if parsed is None:
        return None
    base = as_tensor(base_cube)
    stamp = as_tensor(np.asarray(_host(psf_stamp), dtype=float), base.device,
                      base.dtype)
    angs = as_tensor(np.asarray(_host(parangles), dtype=float), base.device,
                     base.dtype)
    reduce = _pattern_reducer(tuple(base.shape), base.element_size(), parsed)
    return [_host(reduce(inject_ladder_adi(base, stamp, angs, r, f, a), angs))
            for r, f, a in specs]


def _sharded_pca_frames_lazy(base_cube, psf_stamp, parangles, specs, algo,
                             algo_dict, mesh):
    """:func:`_batched_pca_frames_lazy` with the patterns laid over the
    ranks of ``mesh``: each rank injects and reduces its share of
    ``specs`` (padded to a multiple of the mesh with the last) on its
    device, and one all_gather hands every rank all the frames. Host
    frames, or None when the algo or its parameters do not qualify."""
    from ..config.parallel import all_gather

    W, r = mesh.size(), mesh.get_local_rank()
    per = -(-len(specs) // W)
    mine = [specs[min(i, len(specs) - 1)] for i in range(r * per,
                                                          (r + 1) * per)]
    frames = _batched_pca_frames_lazy(base_cube, psf_stamp, parangles, mine,
                                      algo, algo_dict)
    if frames is None:
        return None
    out = all_gather(as_tensor(np.stack(frames)), mesh)[:len(specs)]
    return list(out.cpu().numpy())


def _process_patterns(cubes_fc, algo, argl, parangles, fwhm_med, algo_dict,
                      batch_patterns, verbose, start_time, pattern_mesh=None):
    """``algo`` over every injected pattern cube (vip_tpu
    contrcurve.py:147): over the ranks of ``pattern_mesh`` when the algo
    qualifies, else the pipeline loop for the port's ``pca``, else one
    black-box call each."""
    if pattern_mesh is not None:
        parsed = _parse_batchable_pca(tuple(cubes_fc[0].shape), algo,
                                      algo_dict)
        if parsed is not None and parsed["scaling"] is None:
            from .sharded import sharded_pattern_frames

            out = sharded_pattern_frames(
                cubes_fc, np.asarray(parangles, float), mesh=pattern_mesh,
                ncomp=parsed["ncomp"], method=parsed["method"],
                collapse=parsed["collapse"], rot_mode=parsed["rot_mode"])
            if verbose:
                print(f"{len(cubes_fc)} patterns processed sharded over "
                      f"{pattern_mesh.size()} devices")
                timing(start_time)
            return list(out)
        if verbose:
            print("pattern_mesh: algo/params not shardable, falling back")
    if batch_patterns:
        frames = _batched_pca_frames(cubes_fc, parangles, algo, algo_dict)
        if frames is not None:
            if verbose:
                print(f"{len(cubes_fc)} patterns processed by the device "
                      "pipeline")
                timing(start_time)
            return frames
        if verbose:
            print("batch_patterns: algo/params not batchable, running "
                  "serially")
    frames = []
    for cfc in cubes_fc:
        kwargs = dict(cube=cfc, angle_list=parangles, verbose=False,
                      **algo_dict)
        if "fwhm" in argl:
            kwargs["fwhm"] = fwhm_med
        frames.append(_host(algo(**kwargs)))
        if verbose:
            print(f"Cube with fake companions processed with "
                  f"{algo.__name__}\nMeasuring its annulus-wise throughput")
            timing(start_time)
    return frames


def throughput(cube, angle_list, psf_template, fwhm, algo, nbranch=1,
               theta=0, inner_rad=1, fc_rad_sep=3, wedge=(0, 360), fc_snr=100,
               noise_sep=1, full_output=False, verbose=True,
               algo_class=None, batch_patterns=True, pattern_mesh=None,
               **algo_dict):
    """Throughput of ``algo`` by injection and recovery of radial patterns
    of fake companions (vip_tpu contrcurve.py:365; same parameters and
    returns, host numpy). With ``batch_patterns`` and the port's ``pca``
    the patterns are injected and reduced on the device (see the module
    docstring); the loop of black-box calls gives the same frames. With
    ``pattern_mesh`` the patterns are reduced over the mesh's ranks (see
    the module docstring)."""
    array = cube
    parangles = np.asarray(_host(angle_list))
    imlib = _value(algo_dict.get("imlib", "vip-fft"))
    interpolation = algo_dict.get("interpolation", "lanczos4")
    nproc = algo_dict.get("nproc", 1)
    if array.ndim not in (3, 4):
        raise TypeError("The input array is not a 3d or 4d cube")
    is4d = array.ndim == 4
    if not is4d:
        if array.shape[0] != parangles.shape[0]:
            raise TypeError("Input parallactic angles vector has wrong "
                            "length")
        if psf_template.ndim != 2:
            raise TypeError("Template PSF is not a frame or 2d array")
        maxfcsep = int((array.shape[1] / 2.0) / fwhm) - 1
        if fc_rad_sep < 3 or fc_rad_sep > maxfcsep:
            raise ValueError("Too large separation between companions in "
                             "the radial patterns. Should lie between 3 and"
                             f" {maxfcsep}")
    else:
        if array.shape[1] != parangles.shape[0]:
            raise TypeError("Input parallactic angles vector has wrong "
                            "length")
        if psf_template.ndim != 3:
            raise TypeError("Template PSF is not a frame, 3d array")
    if psf_template.shape[1] % 2 == 0:
        raise ValueError("Only odd-sized PSF is accepted")
    if not hasattr(algo, "__call__"):
        raise TypeError("Parameter `algo` must be a callable function")
    if not isinstance(inner_rad, int):
        raise TypeError("inner_rad must be an integer")
    angular_range = wedge[1] - wedge[0]
    if nbranch > 1 and angular_range < 360:
        raise RuntimeError("Only a single branch is allowed when working on "
                           "a wedge")
    fwhm_med = np.median(fwhm) if isinstance(fwhm, (np.ndarray, list)) \
        else fwhm
    start_time = time_ini(verbose) if verbose else None
    argl = _check_algo(algo, algo_class)

    # the port's pca with pipeline parameters: the empty reduction too runs
    # through the device reducer (a ladder of zero flux on the base cube,
    # which crosses to the device here, once)
    lazy_algo = (batch_patterns and imlib == "vip-fft"
                 and algo_dict.get("scaling") is None
                 and _parse_batchable_pca(tuple(array.shape), algo,
                                          algo_dict) is not None)
    base_dev = None
    if lazy_algo:
        base_dev = as_tensor(array)
        frame_nofc = _batched_pca_frames_lazy(
            base_dev, np.zeros((1, 1)), parangles,
            [(np.zeros(1), np.zeros(1), 0.0)], algo, algo_dict)[0]
    elif "fwhm" in argl:
        frame_nofc = _host(algo(cube=array, angle_list=parangles,
                                fwhm=fwhm_med, verbose=False, **algo_dict))
    else:
        frame_nofc = _host(algo(cube=array, angle_list=parangles,
                                verbose=False, **algo_dict))
    if algo_dict.pop("scaling", None):
        new_algo_dict = dict(algo_dict, scaling=None)
        if "fwhm" in argl:
            frame_nofc_noscal = _host(algo(
                cube=array, angle_list=parangles, fwhm=fwhm_med,
                verbose=False, **new_algo_dict))
        else:
            frame_nofc_noscal = _host(algo(cube=array, angle_list=parangles,
                                           verbose=False, **new_algo_dict))
    else:
        frame_nofc_noscal = frame_nofc
    if verbose:
        print(f"Cube without fake companions processed with {algo.__name__}")
        timing(start_time)

    sep = fwhm_med if noise_sep is None else noise_sep
    noise, res_level, vector_radd = noise_per_annulus(
        frame_nofc, separation=sep, fwhm=fwhm_med, wedge=wedge)
    noise_noscal, _, _ = noise_per_annulus(frame_nofc_noscal, separation=sep,
                                           fwhm=fwhm_med, wedge=wedge)
    vector_radd = vector_radd[inner_rad - 1:]
    noise = noise[inner_rad - 1:]
    res_level = res_level[inner_rad - 1:]
    noise_noscal = noise_noscal[inner_rad - 1:]
    if verbose:
        print("Measured annulus-wise noise in resulting frame")
        timing(start_time)

    new_psf_size = int(round(3 * fwhm_med))
    if new_psf_size % 2 == 0:
        new_psf_size += 1
    if is4d and isinstance(fwhm, (int, float)):
        fwhm = [fwhm] * array.shape[0]
    psf_template = normalize_psf(psf_template, fwhm=fwhm, verbose=verbose,
                                 size=min(new_psf_size,
                                          psf_template.shape[-1]))

    y, x = array.shape[-2:]
    angle_branch = angular_range / nbranch
    lazy = (batch_patterns and imlib == "vip-fft"
            and psf_template.shape[-1] <= min(y, x)
            and _parse_batchable_pca(tuple(array.shape), algo,
                                     algo_dict) is not None)
    thruput_arr = np.zeros((nbranch, noise.shape[0]))
    frame_fc_all = np.zeros((nbranch * fc_rad_sep, y, x))
    chans = (array.shape[0],) if is4d else ()
    fc_map_all = np.zeros((nbranch * fc_rad_sep,) + chans + (y, x))
    cy, cx = frame_center((y, x))

    def build_pattern(br, irad):
        """The companion ladder of one (branch, radial pattern): (cube or
        ladder spec, fc_map, fcy, fcx) (vip_tpu contrcurve.py:519). 3-d
        keeps one azimuth a branch; 4-d steps the azimuth with the radius,
        and its injection ignores the branch offset that its photometry
        keeps (vip_tpu's, and VIP's contrcurve.py:976-1007)."""
        radvec = vector_radd[irad::fc_rad_sep]
        if is4d:
            thetavec = list(range(int(theta), int(theta) + 360,
                                  360 // len(radvec)))
        else:
            thetavec = [theta] * len(radvec)
        cube_fc = None if lazy else _host(array).copy()
        fc_map = np.ones_like(fc_map_all[0]) * 1e-6
        fcy, fcx, fluxes = [], [], []
        for i, rad in enumerate(radvec):
            flux = fc_snr * noise_noscal[irad + i * fc_rad_sep]
            if not lazy:
                cube_fc = cube_inject_companions(
                    cube_fc, psf_template, parangles, flux, rad_dists=[rad],
                    theta=thetavec[i] if is4d
                    else br * angle_branch + thetavec[i], nproc=nproc,
                    imlib=imlib, interpolation=interpolation,
                    copy_array=False, verbose=False)
            ang = np.deg2rad(br * angle_branch + thetavec[i])
            yi = cy + rad * np.sin(ang)
            xi = cx + rad * np.cos(ang)
            fc_map = frame_inject_companion(fc_map, psf_template, yi, xi,
                                            flux, imlib, interpolation)
            fcy.append(yi)
            fcx.append(xi)
            fluxes.append(flux)
        if lazy:
            spec = (np.asarray(radvec, dtype=float),
                    np.asarray(fluxes, dtype=float),
                    float(np.deg2rad(br * angle_branch + theta)))
            return spec, fc_map, fcy, fcx
        return cube_fc, fc_map, fcy, fcx

    patterns = [(br, irad) for br in range(nbranch)
                for irad in range(fc_rad_sep)]
    built = []
    for br, irad in patterns:
        built.append(build_pattern(br, irad))
        if verbose:
            print(f"Fake companions injected in branch {br + 1} "
                  f"(pattern {irad + 1}/{fc_rad_sep})")
            timing(start_time)

    if lazy and pattern_mesh is not None:
        frames_fc = _sharded_pca_frames_lazy(
            array if base_dev is None else base_dev, psf_template,
            parangles, [b[0] for b in built], algo, algo_dict, pattern_mesh)
        if verbose:
            print(f"{len(built)} patterns injected and reduced over the "
                  "mesh")
            timing(start_time)
    elif lazy:
        frames_fc = _batched_pca_frames_lazy(
            array if base_dev is None else base_dev, psf_template,
            parangles, [b[0] for b in built], algo, algo_dict)
        if verbose:
            print(f"{len(built)} patterns injected and reduced on the "
                  "device")
            timing(start_time)
    else:
        frames_fc = _process_patterns(
            [b[0] for b in built], algo, argl, parangles, fwhm_med,
            algo_dict, batch_patterns, verbose, start_time,
            pattern_mesh=pattern_mesh)

    fcys = [b[2] for b in built]
    fcxs = [b[3] for b in built]
    recovered = aperture_flux_images(
        np.stack([frames_fc[k] - frame_nofc for k in range(len(patterns))]),
        fcys, fcxs, fwhm_med / 2)
    if is4d:
        per_ch = [aperture_flux_images(
            np.stack([b[1][ch] for b in built]), fcys, fcxs, fwhm[ch] / 2)
            for ch in range(array.shape[0])]
        injected = [np.mean([_host(per_ch[ch][k])
                             for ch in range(array.shape[0])], axis=0)
                    for k in range(len(patterns))]
    else:
        injected = aperture_flux_images(np.stack([b[1] for b in built]),
                                        fcys, fcxs, fwhm_med / 2)
    for k, (br, irad) in enumerate(patterns):
        ratio = _host(recovered[k]) / _host(injected[k])
        thruput_arr[br, irad::fc_rad_sep] = np.where(ratio < 0, 0, ratio)
        fc_map_all[br * fc_rad_sep + irad] = built[k][1]
        frame_fc_all[br * fc_rad_sep + irad] = frames_fc[k]
    if verbose:
        print(f"Finished measuring the throughput in {nbranch} branches")
        timing(start_time)
    if full_output:
        return (thruput_arr, noise, res_level, vector_radd, frame_fc_all,
                frame_nofc, fc_map_all)
    return thruput_arr, vector_radd


def _contrast_curve(cube, angle_list, psf_template, fwhm, pxscale, starphot,
                    algo, sigma=5, nbranch=1, theta=0, inner_rad=1,
                    fc_rad_sep=3, noise_sep=1, wedge=(0, 360), fc_snr=100,
                    student=True, transmission=None, smooth=True,
                    interp_order=2, plot=True, dpi=100, debug=False,
                    verbose=True, save_plot=None, object_name=None,
                    frame_size=None, fix_y_lim=(), figsize=(8, 5),
                    algo_class=None, batch_patterns=True, pattern_mesh=None,
                    **algo_dict):
    """``contrast_curve`` without pandas: (columns, frame_fc_all,
    frame_nofc, fc_map_all), the columns a dict of host numpy arrays
    under the names of vip_tpu's table (vip_tpu contrcurve.py:717-888)."""
    if cube.ndim != 3 and cube.ndim != 4:
        raise TypeError("The input array is not a 3d or 4d cube")
    angle_list = np.asarray(_host(angle_list))
    if cube.shape[cube.ndim - 3] != angle_list.shape[0]:
        raise TypeError("Input parallactic angles vector has wrong length")
    if cube.ndim == 3 and psf_template.ndim != 2:
        raise TypeError("Template PSF is not a frame (for ADI case)")
    if cube.ndim == 4 and psf_template.ndim != 3:
        raise TypeError("Template PSF is not a cube (for ADI+IFS case)")
    if transmission is not None:
        transmission = np.asarray(transmission, dtype=float)
        if len(transmission) != 2 and len(transmission) != cube.shape[0] + 1:
            raise TypeError("transmission vector should have 2 or 1+n_ch "
                            "rows")
    fwhm_med = np.median(fwhm) if isinstance(fwhm, (np.ndarray, list)) \
        else fwhm
    if verbose:
        start_time = time_ini()
        msg0 = "ALGO : {}, FWHM = {}, # BRANCHES = {}, SIGMA = {}"
        if isinstance(starphot, (float, int)):
            print((msg0 + ", STARPHOT = {}").format(
                algo.__name__, fwhm_med, nbranch, sigma, starphot))
        else:
            print(msg0.format(algo.__name__, fwhm_med, nbranch, sigma))

    res_throug = throughput(cube, angle_list, psf_template, fwhm, algo=algo,
                            nbranch=nbranch, theta=theta, inner_rad=inner_rad,
                            fc_rad_sep=fc_rad_sep, wedge=wedge, fc_snr=fc_snr,
                            noise_sep=noise_sep, full_output=True,
                            verbose=verbose == 2, algo_class=algo_class,
                            batch_patterns=batch_patterns,
                            pattern_mesh=pattern_mesh, **algo_dict)
    vector_radd = res_throug[3]
    if res_throug[0].shape[0] > 1:
        thruput_mean = np.nanmean(res_throug[0], axis=0)
    else:
        thruput_mean = res_throug[0][0]
    frame_fc_all, frame_nofc, fc_map_all = res_throug[4:7]
    if verbose:
        print("Finished the throughput calculation")
        timing(start_time)

    if transmission is not None:
        transmission = _extend_transmission(transmission, cube.shape[-1])
        if transmission.shape[0] > 2:
            transmission = np.array([transmission[0],
                                     np.mean(transmission[1:], axis=0)])

    if interp_order is not None or noise_sep is not None:
        if noise_sep is None:
            rad_samp = vector_radd
            noise_samp = res_throug[1]
            res_lev_samp = res_throug[2]
        else:
            noise_samp, res_lev_samp, rad_samp = noise_per_annulus(
                frame_nofc, separation=noise_sep, fwhm=fwhm_med,
                init_rad=fwhm_med, wedge=wedge)
        radmin = vector_radd.astype(int).min()
        cutin1 = np.where(rad_samp.astype(int) == radmin)[0][0]
        noise_samp = noise_samp[cutin1:]
        res_lev_samp = res_lev_samp[cutin1:]
        rad_samp = rad_samp[cutin1:]
        radmax_fwhm = int(((cube.shape[-1] - 1) // 2) - fwhm_med / 2)
        radtmp = min(vector_radd.astype(int).max(), radmax_fwhm)
        while len(np.where(rad_samp.astype(int) == radtmp)[0]) == 0:
            radtmp -= 1
        cutin2 = np.where(rad_samp.astype(int) == radtmp)[0][0]
        noise_samp = noise_samp[: cutin2 + 1]
        res_lev_samp = res_lev_samp[: cutin2 + 1]
        rad_samp = rad_samp[: cutin2 + 1]
        if interp_order is not None:
            f = InterpolatedUnivariateSpline(vector_radd, thruput_mean,
                                             k=interp_order)
            thruput_interp = f(rad_samp)
        else:
            thruput_interp = thruput_mean.copy()
        if transmission is not None:
            f2 = InterpolatedUnivariateSpline(transmission[0],
                                              transmission[1], k=1)
            thruput_interp *= f2(rad_samp)
    else:
        rad_samp = vector_radd
        noise_samp = res_throug[1]
        res_lev_samp = res_throug[2]
        thruput_interp = thruput_mean
        if transmission is not None:
            if not transmission[1].shape == thruput_interp.shape:
                raise ValueError("Transmiss. and throughput vectors have "
                                 "different length")
            thruput_interp *= transmission[1]

    rad_samp_arcsec = rad_samp * pxscale
    # VIP zeroes the residual level (contrcurve.py:356-358)
    res_lev_samp = np.zeros_like(res_lev_samp)
    if smooth:
        win = min(noise_samp.shape[0] - 2, int(2 * fwhm_med))
        if win % 2 == 0:
            win += 1
        noise_samp_sm = savgol_filter(noise_samp, polyorder=2,
                                      mode="nearest", window_length=win)
        res_lev_samp_sm = savgol_filter(res_lev_samp, polyorder=2,
                                        mode="nearest", window_length=win)
    else:
        noise_samp_sm = noise_samp
        res_lev_samp_sm = res_lev_samp

    starphot_val = starphot if isinstance(starphot, (float, int)) \
        else np.median(starphot)
    cont_curve_samp = ((sigma * noise_samp_sm + res_lev_samp_sm)
                       / thruput_interp) / starphot_val
    cont_curve_samp[np.where(cont_curve_samp < 0)] = 1
    cont_curve_samp[np.where(cont_curve_samp > 1)] = 1
    if student:
        n_res_els = np.floor(rad_samp / fwhm_med * 2 * np.pi)
        ss_corr = np.sqrt(1 + 1 / n_res_els)
        sigma_corr = stats.t.ppf(stats.norm.cdf(sigma),
                                 n_res_els - 1) * ss_corr
        cont_curve_samp_corr = ((sigma_corr * noise_samp_sm
                                 + res_lev_samp_sm)
                                / thruput_interp) / starphot_val
        cont_curve_samp_corr[np.where(cont_curve_samp_corr < 0)] = 1
        cont_curve_samp_corr[np.where(cont_curve_samp_corr > 1)] = 1

    if debug:
        _plot_debug(vector_radd * pxscale, thruput_mean, rad_samp_arcsec,
                    thruput_interp, noise_samp, noise_samp_sm if smooth
                    else None, figsize, dpi)
    if plot or debug:
        _plot_contrast(rad_samp_arcsec, cont_curve_samp,
                       cont_curve_samp_corr if student else None, sigma,
                       debug, figsize, dpi, save_plot, fix_y_lim,
                       object_name, frame_size, inner_rad, algo_dict)

    columns = {"sensitivity_gaussian": cont_curve_samp}
    if student:
        columns["sensitivity_student"] = cont_curve_samp_corr
    columns.update({"throughput": thruput_interp, "distance": rad_samp,
                    "distance_arcsec": rad_samp_arcsec,
                    "noise": noise_samp_sm,
                    "residual_level": res_lev_samp_sm})
    if student:
        columns["sigma corr"] = sigma_corr
    return columns, frame_fc_all, frame_nofc, fc_map_all


def _plot_debug(rad_thr, thruput, rad_arcsec, thruput_interp, noise,
                noise_sm, figsize, dpi):
    """The throughput and noise figures of ``contrast_curve(debug=True)``
    (vip_tpu contrcurve.py:799-824)."""
    import matplotlib.pyplot as plt

    plt.figure(figsize=figsize, dpi=dpi)
    plt.plot(rad_thr, thruput, ".", label="computed", alpha=0.6)
    plt.plot(rad_arcsec, thruput_interp, ",-", label="interpolated", lw=2,
             alpha=0.5)
    plt.grid("on", which="both", alpha=0.2, linestyle="solid")
    plt.xlabel("Angular separation [arcsec]")
    plt.ylabel("Throughput")
    plt.legend(loc="best")
    plt.xlim(0, np.max(rad_arcsec))
    plt.figure(figsize=figsize, dpi=dpi)
    plt.plot(rad_arcsec, noise, ".", label="computed", alpha=0.6)
    if noise_sm is not None:
        plt.plot(rad_arcsec, noise_sm, ",-", label="noise smoothed", lw=2,
                 alpha=0.5)
    plt.grid("on", alpha=0.2, linestyle="solid")
    plt.xlabel("Angular separation [arcsec]")
    plt.ylabel("Noise")
    plt.legend(loc="best")
    plt.xlim(0, np.max(rad_arcsec))


def _plot_contrast(rad_arcsec, curve, curve_student, sigma, debug, figsize,
                   dpi, save_plot, fix_y_lim, object_name, frame_size,
                   inner_rad, algo_dict):
    """The contrast figure of ``contrast_curve``, and with ``debug`` its
    delta-magnitude view (vip_tpu contrcurve.py:826-867);
    ``curve_student`` is None without the Student correction."""
    import matplotlib.pyplot as plt

    plt.figure(figsize=figsize, dpi=dpi)
    plt.plot(rad_arcsec, curve, "-", label=f"{sigma} sigma contrast")
    if curve_student is not None:
        plt.plot(rad_arcsec, curve_student, "--",
                 label=f"{sigma} sigma contrast (Student)")
    plt.yscale("log")
    plt.xlabel("Angular separation [arcsec]")
    plt.ylabel(f"{sigma} sigma contrast")
    plt.legend()
    if object_name is not None and frame_size is not None:
        pca_type = "ADI" if algo_dict.get("cube_ref") is None else "RDI"
        plt.title(f"{pca_type} {object_name} {algo_dict.get('ncomp')}pc "
                  f"{frame_size} + {inner_rad}", fontsize=14)
    if len(fix_y_lim) == 2:
        plt.ylim(min(fix_y_lim), max(fix_y_lim))
    if save_plot is not None:
        plt.savefig(save_plot, dpi=dpi)
    if not debug:
        return
    plt.figure(figsize=figsize, dpi=dpi)
    with np.errstate(divide="ignore"):
        plt.plot(rad_arcsec, -2.5 * np.log10(curve), ".-", alpha=0.4,
                 color="green", label="Sensitivity (Gaussian)")
        if curve_student is not None:
            plt.plot(rad_arcsec, -2.5 * np.log10(curve_student), ".-",
                     alpha=0.4, color="blue",
                     label="Sensitivity (Student-t correction)")
    plt.legend(fancybox=True, fontsize="medium")
    plt.xlabel("Angular separation [arcsec]")
    plt.ylabel("Delta magnitude")
    plt.gca().invert_yaxis()
    plt.grid("on", which="both", alpha=0.2, linestyle="solid")


def contrast_curve(cube, angle_list, psf_template, fwhm, pxscale, starphot,
                   algo, sigma=5, nbranch=1, theta=0, inner_rad=1,
                   fc_rad_sep=3, noise_sep=1, wedge=(0, 360), fc_snr=100,
                   student=True, transmission=None, smooth=True,
                   interp_order=2, plot=True, dpi=100, debug=False,
                   verbose=True, full_output=False, save_plot=None,
                   object_name=None, frame_size=None, fix_y_lim=(),
                   figsize=(8, 5), algo_class=None, batch_patterns=True,
                   pattern_mesh=None, **algo_dict):
    """Contrast curve at ``sigma`` confidence, with the [MAW14]
    small-sample (Student) correction (vip_tpu contrcurve.py:621; same
    parameters and returns): a pandas ``DataFrame`` of the columns of
    ``_contrast_curve``, and with ``full_output`` also the frames with
    and without the fake companions and their maps."""
    columns, frame_fc_all, frame_nofc, fc_map_all = _contrast_curve(
        cube, angle_list, psf_template, fwhm, pxscale, starphot, algo,
        sigma=sigma, nbranch=nbranch, theta=theta, inner_rad=inner_rad,
        fc_rad_sep=fc_rad_sep, noise_sep=noise_sep, wedge=wedge,
        fc_snr=fc_snr, student=student, transmission=transmission,
        smooth=smooth, interp_order=interp_order, plot=plot, dpi=dpi,
        debug=debug, verbose=verbose, save_plot=save_plot,
        object_name=object_name, frame_size=frame_size, fix_y_lim=fix_y_lim,
        figsize=figsize, algo_class=algo_class,
        batch_patterns=batch_patterns, pattern_mesh=pattern_mesh,
        **algo_dict)
    import pandas as pd

    datafr = pd.DataFrame(columns)
    if full_output:
        return datafr, frame_fc_all, frame_nofc, fc_map_all
    return datafr

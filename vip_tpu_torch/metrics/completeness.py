"""Completeness-based contrast curves and maps ([DAH21b], [JEN18]; port
of ``vip_tpu.metrics.completeness``).

For each radius, a search over the injected flux finds the level at
which the wanted fraction of ``n_fc`` azimuthal injections is detected
(the S/N at the injection above the largest S/N elsewhere in the map of
the reduction without companions). With the port's ``psfsub.pca`` and
pipeline parameters every probe is injected and reduced on the device,
the cube moved there once (the contrast curve's pattern loop,
``contrcurve._batched_pca_frames_lazy``); other algos are called once
per position on host-injected cubes. The S/N maps and the search are
host numpy, the photometry on the device.
"""

import numpy as np

from ..config.device import as_tensor
from ..config.utils_conf import iterable, pool_map
from ..fm.fakecomp import _host, cube_inject_companions, normalize_psf
from ..fm.utils_negfc import find_nearest
from ..preproc.cosmetics import cube_crop_frames
from ..var.coords import frame_center
from ..var.shapes import get_annulus_segments
from .contrcurve import (_batched_pca_frames, _batched_pca_frames_lazy,
                         _check_algo, _contrast_curve, _parse_batchable_pca)
from .snr_source import _snrmap_approx, snr_multi, snrmap

__all__ = ["completeness_curve", "completeness_map"]


def _median_fwhm(fwhm):
    """Scalar FWHM: the median over IFS channels when a vector is given."""
    return np.median(fwhm) if isinstance(fwhm, (np.ndarray, list)) else fwhm


def _check_cube_psf(cube, angle_list, psf):
    n_fr = cube.shape[0] if cube.ndim == 3 else cube.shape[1]
    if n_fr != angle_list.shape[0]:
        raise TypeError("Input parallactic angles vector has wrong length")
    if cube.ndim == 3 and psf.ndim != 2:
        raise TypeError("Template PSF is not a frame (for ADI case)")
    if cube.ndim == 4 and psf.ndim != 3:
        raise TypeError("Template PSF is not a cube (for ADI+IFS case)")


def _run_dict(algo, algo_dict, fwhm_med):
    """``algo_dict`` with verbose off and the FWHM, where ``algo`` takes
    them."""
    argl = _check_algo(algo, None)
    run = dict(algo_dict)
    if "verbose" in argl:
        run["verbose"] = False
    if "fwhm" in argl:
        run["fwhm"] = fwhm_med
    return run, "radius_int" in argl


def _estimate_snr_fc(a, b, level, n_fc, cube, psf, angle_list, fwhm, algo,
                     algo_dict, snrmap_empty, starphot=1, approximated=True):
    """Inject one companion at (r = a, theta = b / n_fc · 360), reduce the
    cube with ``algo`` and return (its detection margin, b) (vip_tpu
    completeness.py:61)."""
    cubefc = cube_inject_companions(cube, psf, angle_list,
                                    flevel=level * starphot, plsc=0.1,
                                    rad_dists=a, theta=b / n_fc * 360,
                                    n_branches=1, verbose=False)
    fwhm_med = _median_fwhm(fwhm)
    cy, cx = frame_center(cube[0, 0] if cube.ndim == 4 else cube[0])
    run, annular = _run_dict(algo, algo_dict, fwhm_med)
    if annular:
        # annular algos need only a few annuli around the injection:
        # crop, reduce, paste the result back onto a full-size frame
        asize = run.get("asize") or int(np.ceil(fwhm))
        n_annuli = 5 if a > 2 * asize else 4
        radius_int = (a // asize - (2 if a > 2 * asize else 1)) * asize
        extent = int(radius_int + n_annuli * asize)
        work = cubefc
        if 2 * extent < cube.shape[-1]:
            work = cube_crop_frames(cubefc, 2 * extent, xy=(cx, cy),
                                    verbose=False)
        reduced = _host(algo(cube=work, angle_list=angle_list,
                             radius_int=radius_int, **run))
        frame_fin = np.zeros(cube.shape[-2:])
        ys, xs = get_annulus_segments(frame_fin, 0, extent, 1)[0]
        off = (frame_fin.shape[0] - reduced.shape[0]) // 2
        frame_fin[ys, xs] = reduced[ys - off, xs - off]
    else:
        frame_fin = _host(algo(cube=cubefc, angle_list=angle_list, **run))
    return _margin_from_frame(frame_fin, a, b, n_fc, fwhm_med, snrmap_empty,
                              annular, approximated), b


def _margin_from_frame(frame_fin, a, b, n_fc, fwhm_med, snrmap_empty,
                       annular, approximated):
    """(largest S/N near the injection − largest S/N elsewhere) of one
    reduced host frame, the S/N of the injection's annulus laid over the
    empty map (vip_tpu completeness.py:106); shared by both branches."""
    cy, cx = frame_center(frame_fin)
    if annular:
        mask = get_annulus_segments(frame_fin, a - (fwhm_med // 2),
                                    fwhm_med + 1, mode="mask")[0]
    else:
        width = min(frame_fin.shape) / 2 - 1.5 * fwhm_med
        mask = get_annulus_segments(frame_fin, (fwhm_med / 2) + 2, width,
                                    mode="mask")[0]
    yy, xx = np.nonzero(_host(mask))

    snr_new = np.zeros_like(frame_fin)
    if approximated:
        snr_new[yy, xx] = _host(_snrmap_approx(as_tensor(frame_fin), yy, xx,
                                               fwhm_med, cy, cx))
    else:
        snr_new[yy, xx] = snr_multi(frame_fin, xx, yy, fwhm_med,
                                    exclude_negative_lobes=True)[0]
    snr_new = np.nan_to_num(snr_new)
    merged = np.where(np.abs(snr_new) > 1e-6, 0, snrmap_empty) + snr_new

    y, x = frame_fin.shape
    azim = 2 * np.pi * b / n_fc
    at_y = int(y / 2 + np.sin(azim) * a)
    at_x = int(x / 2 + np.cos(azim) * a)
    near = ((np.arange(y)[:, None] - at_y) ** 2
            + (np.arange(x)[None, :] - at_x) ** 2) < 16
    max_target = np.nan_to_num(merged[near]).max()
    max_rest = np.nan_to_num(np.where(near, 0, merged)).max()
    return max_target - max_rest


def _run_batch(nproc, a, bs, level, n_fc, cube, psf, angle_list, fwhm, algo,
               algo_dict, snrmap_empty, starphot, approximated):
    """Margins of the positions ``bs`` at ``level``: the device pattern
    loop for the port's ``pca``, else ``algo`` once per position
    (vip_tpu completeness.py:148)."""
    res = _run_batch_device(a, bs, level, n_fc, cube, psf, angle_list, fwhm,
                            algo, algo_dict, snrmap_empty, starphot,
                            approximated)
    if res is not None:
        return res
    return pool_map(nproc, _estimate_snr_fc, a, iterable(bs), level, n_fc,
                    cube, psf, angle_list, fwhm, algo, algo_dict,
                    snrmap_empty, starphot, approximated=approximated)


def _run_batch_device(a, bs, level, n_fc, cube, psf, angle_list, fwhm, algo,
                      algo_dict, snrmap_empty, starphot, approximated):
    """The positions ``bs`` injected and reduced on the device, one after
    another, through the contrast curve's pattern loop (vip_tpu
    completeness.py:167). None when the algo or its parameters do not
    qualify."""
    if cube.ndim != 3 or len(bs) == 0:
        return None
    fwhm_med = _median_fwhm(fwhm)
    run, annular = _run_dict(algo, algo_dict, fwhm_med)
    if annular:
        return None
    probe = {k: v for k, v in run.items() if k not in ("verbose", "fwhm")}
    psf_np = _host(psf)
    frames = None
    if psf_np.ndim == 2 and psf_np.shape[-1] <= min(cube.shape[-2:]):
        specs = [(np.atleast_1d(np.asarray(a, dtype=float)),
                  np.atleast_1d(np.asarray(level * starphot, dtype=float)),
                  float(np.deg2rad(b / n_fc * 360))) for b in bs]
        frames = _batched_pca_frames_lazy(cube, psf_np, angle_list, specs,
                                          algo, probe)
    if frames is None:
        cubes_fc = [cube_inject_companions(cube, psf, angle_list,
                                           flevel=level * starphot, plsc=0.1,
                                           rad_dists=a, theta=b / n_fc * 360,
                                           n_branches=1, verbose=False)
                    for b in bs]
        frames = _batched_pca_frames(cubes_fc, angle_list, algo, probe)
    if frames is None:
        return None
    return [(_margin_from_frame(fr, a, b, n_fc, fwhm_med, snrmap_empty, False,
                                approximated), b)
            for fr, b in zip(frames, bs)]


class _DetectionLedger:
    """Monotonic memo of detections over the ``n_fc`` positions at one
    radius (vip_tpu completeness.py:211): a position detected at some
    level counts as detected above it, a miss counts below it, so
    ``count(level)`` reduces only the positions still unknown there."""

    def __init__(self, prober, n_fc):
        self._prober = prober
        self._lowest_hit = np.full(n_fc, np.inf)
        self._highest_miss = np.full(n_fc, -np.inf)

    def count(self, level):
        """Detected positions at ``level``, probing the unknown ones."""
        unknown = np.where((level < self._lowest_hit)
                           & (level > self._highest_miss))[0]
        if unknown.size:
            hits = self._prober(level, unknown)
            hit_idx = unknown[hits]
            miss_idx = unknown[~hits]
            self._lowest_hit[hit_idx] = np.minimum(
                self._lowest_hit[hit_idx], level)
            self._highest_miss[miss_idx] = np.maximum(
                self._highest_miss[miss_idx], level)
        return int(np.sum(level >= self._lowest_hit))


def _level_for_count(ledger, start_level, target, max_iter, err_msg):
    """A flux level at which exactly ``target`` positions are detected
    (vip_tpu completeness.py:245): geometric steps to bracket the count,
    then secant steps on (count, level) with a bisection fallback."""
    level = start_level
    lo = hi = None  # (level, count) with count < target / >= target
    for _ in range(max_iter):
        count = ledger.count(level)
        if count == target:
            return level
        if count < target:
            if lo is None or level > lo[0]:
                lo = (level, count)
        elif hi is None or level < hi[0]:
            hi = (level, count)
        if lo is None:
            level = hi[0] * 0.5
        elif hi is None:
            level = lo[0] * 1.5
        else:
            lo_lvl, lo_cnt = lo
            hi_lvl, hi_cnt = hi
            level = lo_lvl + (hi_lvl - lo_lvl) * (target - lo_cnt) \
                / max(hi_cnt - lo_cnt, 1)
            if not lo_lvl < level < hi_lvl:
                level = 0.5 * (lo_lvl + hi_lvl)
    raise ValueError(err_msg.format(max_iter, level))


_ERR_MSG = ("Could not converge on a contrast level matching required "
            "completeness within {} iterations. Tested level: {}. Is "
            "there too much self-subtraction? Consider decreasing ncomp "
            "if using PCA, or increasing minimum requested radius.")


def _empty_snrmap(cube, angle_list, fwhm_med, algo, algo_dict, nproc,
                  snr_approximation):
    """Host S/N map of the reduction of the cube without companions."""
    argl = _check_algo(algo, None)
    algo_dict = dict(algo_dict, verbose=False)
    if "fwhm" in argl:
        frame_fin = algo(cube=cube, angle_list=angle_list, fwhm=fwhm_med,
                         **algo_dict)
    else:
        frame_fin = algo(cube=cube, angle_list=angle_list, **algo_dict)
    return _host(snrmap(as_tensor(_host(frame_fin)), fwhm_med,
                        approximated=snr_approximation, plot=False,
                        known_sources=None, nproc=nproc, array2=None,
                        use2alone=False, exclude_negative_lobes=False,
                        verbose=False))


def _prepare(cube, angle_list, psf, fwhm, algo, algo_dict):
    """Set-up shared by ``completeness_curve`` and ``completeness_map``:
    host angles, the median FWHM, the normalized PSF, and the cube moved
    to the default device once when the probes run there."""
    angle_list = np.asarray(_host(angle_list))
    _check_cube_psf(cube, angle_list, psf)
    fwhm_med = _median_fwhm(fwhm)
    if _parse_batchable_pca(tuple(cube.shape), algo, dict(algo_dict)) \
            is not None:
        cube = as_tensor(cube)
    new_psf_size = int(round(3 * fwhm_med))
    if new_psf_size % 2 == 0:
        new_psf_size += 1
    psf = normalize_psf(psf, fwhm=fwhm, verbose=False,
                        size=min(new_psf_size, psf.shape[1]))
    return cube, angle_list, fwhm_med, psf


def _initial_contrast(cube, angle_list, psf, fwhm_med, an_dist, pxscale,
                      starphot, algo, algo_class, algo_dict):
    """The Student contrast of a 3-sigma contrast curve at each radius of
    ``an_dist``, without pandas."""
    print("Contrast curve not provided => will be computed first...")
    cols = _contrast_curve(cube, angle_list, psf, fwhm_med, pxscale,
                           starphot, algo, sigma=3, nbranch=1, theta=0,
                           inner_rad=1, wedge=(0, 360), fc_snr=100,
                           plot=False, algo_class=algo_class,
                           **algo_dict)[0]
    ini_rads = np.array(cols["distance"])
    ini_cc = np.array(cols["sensitivity_student"])
    if np.amax(an_dist) > np.amax(ini_rads):
        raise ValueError("Max requested annular distance larger than "
                         "covered by contrast curve. Please decrease "
                         "the maximum annular distance")
    return [ini_cc[find_nearest(ini_rads, ad)] for ad in an_dist]


def _prober(a, nproc, n_fc, cube, psf, angle_list, fwhm, algo, algo_dict,
            snrmap_empty, starphot, approximated):
    """Detections (margin > 0) of the given positions at a level."""
    def probe(level, positions):
        res = _run_batch(nproc, a, positions, level, n_fc, cube, psf,
                         angle_list, fwhm, algo, algo_dict, snrmap_empty,
                         starphot, approximated)
        by_pos = dict((b, margin) for margin, b in res)
        return np.array([by_pos[b] > 0 for b in positions])
    return probe


def completeness_curve(cube, angle_list, psf, fwhm, algo, an_dist=None,
                       ini_contrast=None, starphot=1, pxscale=0.1, n_fc=20,
                       completeness=0.95, snr_approximation=True,
                       max_iter=50, nproc=1, algo_dict={}, verbose=True,
                       plot=True, dpi=100, save_plot=None, object_name=None,
                       fix_y_lim=(), figsize=(8, 5), algo_class=None):
    """Contrast at ``completeness`` against radius (vip_tpu
    completeness.py:303; same parameters). Returns (an_dist,
    cont_curve). ``nproc`` changes nothing: the probes run one after
    another."""
    nproc = nproc or 1
    fwhm_med0 = _median_fwhm(fwhm)
    if an_dist is None:
        an_dist = np.array(range(2 * round(fwhm_med0),
                                 int(cube.shape[-1] // 2 - 2 * fwhm_med0), 5))
        print("an_dist not provided, the following list will be used:",
              an_dist)
    elif an_dist[-1] > cube.shape[-1] // 2 - 2 * fwhm_med0:
        raise TypeError("Please decrease the maximum annular distance")
    if ini_contrast is None:
        ini_contrast = _initial_contrast(
            cube, _host(angle_list), psf, fwhm_med0, an_dist, pxscale,
            starphot, algo, algo_class, algo_dict)
    if verbose:
        print("Calculating initial SNR map with no injected companion...")
    cube, angle_list, fwhm_med, psf = _prepare(cube, angle_list, psf, fwhm,
                                               algo, algo_dict)
    snrmap_empty = _empty_snrmap(cube, angle_list, fwhm_med, algo,
                                 algo_dict, nproc, snr_approximation)

    cont_curve = np.zeros(len(an_dist))
    target = round(completeness * n_fc)
    for k, a in enumerate(an_dist):
        if verbose:
            print("*** Calculating contrast at r = {} ***".format(a))
        ledger = _DetectionLedger(
            _prober(a, nproc, n_fc, cube, psf, angle_list, fwhm, algo,
                    algo_dict, snrmap_empty, starphot, snr_approximation),
            n_fc)
        level = _level_for_count(ledger, ini_contrast[k], target, max_iter,
                                 _ERR_MSG)
        if verbose:
            print("=> found final contrast for {}% completeness: "
                  "{}".format(completeness * 100, level))
        cont_curve[k] = level

    if plot:
        import matplotlib.pyplot as plt

        an_dist_arcsec = np.asarray(an_dist) * pxscale
        fig = plt.figure(figsize=figsize, dpi=dpi)
        ax1 = fig.add_subplot(111)
        ax1.plot(an_dist_arcsec, cont_curve, "-", alpha=0.2, lw=2,
                 color="green")
        ax1.plot(an_dist_arcsec, cont_curve, ".", alpha=0.2, color="green")
        plt.xlabel("Angular separation [arcsec]")
        plt.ylabel(str(int(completeness * 100)) + "% completeness contrast")
        plt.grid("on", which="both", alpha=0.2, linestyle="solid")
        if object_name is not None:
            pca_type = "ADI" if algo_dict.get("cube_ref") is None else "RDI"
            plt.title(f"{pca_type} {object_name} {algo_dict.get('ncomp')}pc",
                      fontsize=14)
        if len(fix_y_lim) == 2:
            ax1.set_ylim(min(fix_y_lim), max(fix_y_lim))
        ax1.set_yscale("log")
        ax1.set_xlim(0, 1.1 * np.max(an_dist_arcsec))
        if save_plot is not None:
            fig.savefig(save_plot, dpi=dpi)
    return an_dist, cont_curve


def completeness_map(cube, angle_list, psf, fwhm, algo, an_dist,
                     ini_contrast, starphot=1, n_fc=20,
                     snr_approximation=True, nproc=1, algo_dict={},
                     verbose=True, algo_class=None):
    """Contrast against radius for every completeness level 1/n_fc ..
    1 − 1/n_fc (vip_tpu completeness.py:400). Returns (an_dist,
    comp_levels, contrast_matrix)."""
    nproc = nproc or 1
    cube, angle_list, fwhm_med, psf = _prepare(cube, angle_list, psf, fwhm,
                                               algo, algo_dict)
    if ini_contrast is None:
        ini_contrast = _initial_contrast(
            cube, angle_list, psf, fwhm_med, an_dist, 0.1, starphot, algo,
            algo_class, algo_dict)
    snrmap_empty = _empty_snrmap(cube, angle_list, fwhm_med, algo,
                                 algo_dict, nproc, snr_approximation)

    contrast_matrix = np.zeros((len(an_dist), n_fc + 1))
    max_iter = 100
    for k, a in enumerate(an_dist):
        if verbose:
            print("Starting annulus {}".format(a))
        ledger = _DetectionLedger(
            _prober(a, nproc, n_fc, cube, psf, angle_list, fwhm, algo,
                    algo_dict, snrmap_empty, starphot, snr_approximation),
            n_fc)
        level_of = {}  # detection count -> a level realizing it

        class _Recorder:
            """Ledger adapter noting every (count, level) pair seen, so
            the searches for the remaining counts start bracketed."""

            @staticmethod
            def count(level):
                c = ledger.count(level)
                level_of.setdefault(c, level)
                return c

        _Recorder.count(ini_contrast[k])
        for c in range(1, n_fc):
            if c in level_of:
                continue
            known = np.array(sorted(level_of))
            nearest = known[np.abs(known - c).argmin()]
            _level_for_count(_Recorder, level_of[nearest], c, max_iter,
                             _ERR_MSG)
            if verbose:
                print("Data point {} found.".format(c / n_fc))
        for c, level in level_of.items():
            contrast_matrix[k, c] = level

    comp_levels = np.linspace(1 / n_fc, 1 - 1 / n_fc, n_fc - 1,
                              endpoint=True)
    return an_dist, comp_levels, contrast_matrix[:, 1:-1]

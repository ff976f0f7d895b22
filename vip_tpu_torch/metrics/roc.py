"""ROC curves (port of ``vip_tpu.metrics.roc``): ``EvalRoc`` injects
companions into copies of a dataset and runs ``PostProc`` objects on each
(the reductions on the dataset's device); the detection maps are then
thresholded on the host (``detect_sources``, ``compute_binary_map``:
numpy and scipy, as in vip_tpu)."""

import copy

import numpy as np
from scipy import ndimage, stats

from ..config.device import as_tensor
from ..config.timing import time_ini, timing
from ..config.utils_conf import Progressbar
from ..fm.fakecomp import _host, cube_inject_companions
from ..var.coords import frame_center
from ..var.shapes import get_annulus_segments, get_circle

__all__ = ["EvalRoc", "detect_sources", "compute_binary_map"]


class _Segment:
    def __init__(self, label, area):
        self.label = label
        self.area = area


class _SegmentationImage:
    """Labelled array, the area of each label and its bounding box (the
    part of photutils' SegmentationImage that ``compute_binary_map``
    reads), from one pass over the array."""

    def __init__(self, data):
        self.data = data
        areas = np.bincount(data.ravel())
        self.slices = ndimage.find_objects(data)
        self.segments = [_Segment(int(lab), int(areas[lab]))
                         for lab in np.flatnonzero(areas) if lab != 0]


def detect_sources(frame, threshold, npix, connectivity=4):
    """Connected regions of ``frame > threshold`` with at least ``npix``
    pixels, labelled 1.. (photutils ``detect_sources``; vip_tpu roc.py:40);
    None when there is none."""
    mask = _host(frame) > threshold
    if not mask.any():
        return None
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]]) \
        if connectivity == 4 else np.ones((3, 3))
    labeled, nlab = ndimage.label(mask, structure=structure)
    # the regions of npix pixels or more, relabelled 1.. in label order
    keep = np.bincount(labeled.ravel(), minlength=nlab + 1) >= npix
    keep[0] = False
    if not keep.any():
        return None
    relabel = np.zeros(nlab + 1, dtype=labeled.dtype)
    relabel[keep] = np.arange(1, int(keep.sum()) + 1)
    return _SegmentationImage(relabel[labeled])


class EvalRoc:
    """Receiver operating characteristic curves of ``PostProc`` objects
    (vip_tpu roc.py:64): random companions injected into the dataset, each
    registered object run on every injected cube, and its S/N maps
    thresholded."""

    def __init__(self, dataset, plsc=0.0272, n_injections=100, inrad=8,
                 outrad=12, dist_flux=("uniform", 2, 500), mask=None):
        self.dataset = dataset
        self.plsc = plsc
        self.n_injections = n_injections
        self.inrad = inrad
        self.outrad = outrad
        self.dist_flux = dist_flux
        self.mask = mask
        self.methods = []

    def add_algo(self, name, algo, color, symbol, thresholds):
        """Register a PostProc object with its plotting style and
        thresholds."""
        self.methods.append(dict(algo=algo, name=name, color=color,
                                 symbol=symbol, thresholds=thresholds))

    def inject_and_postprocess(self, patch_size=None, cevr=0.9,
                               expvar_mode="annular", nproc=1, *, rng=None):
        """Inject companions at random positions and fluxes, and run every
        registered object on each injected cube (vip_tpu roc.py:84).

        The fluxes, then the positions, are drawn in vip_tpu's order from
        ``rng`` (a ``numpy.random.RandomState``; numpy's global state by
        default), so one seed gives both packages the same injections.
        ``cevr`` picks the number of principal components from the
        dataset's explained variance (no table or plot is made). Each
        injected cube (host float64, ``fm.cube_inject_companions``) goes
        back to the dataset cube's device and dtype before the objects
        run; their frames and S/N maps are kept as they return them."""
        from ..psfsub.svd import SVDecomposer

        draws = np.random if rng is None else rng
        starttime = time_ini()
        cube = self.dataset.cube
        if cevr is not None:
            svdecomp = SVDecomposer(cube, mode=expvar_mode,
                                    inrad=self.inrad, outrad=self.outrad,
                                    svd_mode="lapack", verbose=False)
            svdecomp._ratios()
            self.optpcs = np.searchsorted(svdecomp.cevr, cevr) + 1
            print("{}% of CEVR with {} PCs".format(cevr, self.optpcs))

        width = self.outrad - self.inrad
        yy, xx = get_annulus_segments(cube[0], self.inrad, width)[0]
        yy, xx = _host(yy, int), _host(xx, int)
        num_patches = yy.shape[0]

        def skewnormal(*args, size):
            return stats.skewnorm.rvs(*args, size=size, random_state=rng)

        dist_fkt = dict(skewnormal=skewnormal, normal=draws.normal,
                        uniform=draws.uniform).get(self.dist_flux[0],
                                                   self.dist_flux[0])
        self.fluxes = dist_fkt(*self.dist_flux[1:], size=self.n_injections)
        self.fluxes.sort()
        inds_inj = draws.randint(0, num_patches, size=self.n_injections)

        cy, cx = frame_center(cube[0])
        self.dists = []
        self.thetas = []
        for m in range(self.n_injections):
            injx = xx[inds_inj[m]] - cx
            injy = yy[inds_inj[m]] - cy
            self.dists.append(np.sqrt(injx**2 + injy**2))
            self.thetas.append(np.mod(np.arctan2(injy, injx) /
                                      np.pi * 180, 360))

        for m in self.methods:
            m["frames"] = []
            m["probmaps"] = []

        self.list_xy = []
        for n in Progressbar(range(self.n_injections), desc="injecting"):
            cufc, cox, coy = _create_synt_cube(cube, self.dataset.psf,
                                               self.dataset.angles,
                                               self.plsc,
                                               theta=self.thetas[n],
                                               flux=self.fluxes[n],
                                               dist=self.dists[n],
                                               verbose=False, rng=rng)
            self.list_xy.append((int(np.round(cox)), int(np.round(coy))))
            cufc = as_tensor(cufc, device=cube.device, dtype=cube.dtype)

            for m in self.methods:
                algo = copy.copy(m["algo"])
                _dataset = copy.copy(self.dataset)
                _dataset.cube = cufc
                if hasattr(algo, "ncomp") and cevr is not None:
                    algo.ncomp = self.optpcs
                algo.run(dataset=_dataset, verbose=False)
                algo.make_snrmap(approximated=True, nproc=nproc,
                                 verbose=False)
                m["frames"].append(algo.frame_final)
                m["probmaps"].append(algo.snr_map)
        timing(starttime)

    def compute_tpr_fps(self, **kwargs):
        """Detections and false positives for each injection, method and
        threshold, on host copies of the maps (vip_tpu roc.py:151)."""
        starttime = time_ini()
        for m in self.methods:
            m["detections"] = []
            m["fps"] = []
            m["bmaps"] = []
        print("Evaluating injections:")
        for i in Progressbar(range(self.n_injections)):
            x, y = self.list_xy[i]
            for m in self.methods:
                dets, fps, bmaps = compute_binary_map(
                    m["probmaps"][i], m["thresholds"],
                    fwhm=self.dataset.fwhm, injections=(x, y), **kwargs)
                m["detections"].append(dets)
                m["fps"].append(fps)
                m["bmaps"].append(bmaps)
        timing(starttime)

    def plot_detmaps(self, i=None, thr=9, dpi=100, axis=True, grid=False,
                     vmin=-10, vmax="max", plot_type="horiz"):
        """Plot host copies of the detection maps of one injection
        (vip_tpu roc.py:171)."""
        import matplotlib.pyplot as plt
        if i is None:
            i = self.n_injections // 2
        for m in self.methods:
            if plot_type in (1, "horiz"):
                fig, axes = plt.subplots(1, 3, figsize=(12, 4), dpi=dpi)
            elif plot_type in (2, "vert"):
                fig, axes = plt.subplots(3, 1, figsize=(4, 12), dpi=dpi)
            else:
                raise ValueError("`plot_type` not recognized")
            frame = _host(m["frames"][i])
            vmax_val = np.nanmax(frame) if vmax == "max" else vmax
            axes[0].imshow(frame, origin="lower", vmin=vmin, vmax=vmax_val)
            axes[0].set_title(f"{m['name']} frame")
            axes[1].imshow(_host(m["probmaps"][i]), origin="lower")
            axes[1].set_title("detection map")
            if thr < len(m["bmaps"][i]):
                axes[2].imshow(m["bmaps"][i][thr], origin="lower",
                               cmap="binary")
            axes[2].set_title(f"binary map (thr #{thr})")
            for ax in axes:
                if not axis:
                    ax.set_axis_off()
                ax.grid(grid)
            plt.show()

    def plot_roc_curves(self, dpi=100, figsize=(5, 5), xmin=None, xmax=None,
                        ymin=-0.05, ymax=1.02, xlog=True, label_skip_one=False,
                        legend_loc="lower right", legend_size=6,
                        show_data_labels=True, hide_overlap_label=True,
                        label_gap=(0, -0.028), save_plot=False,
                        label_params={}, line_params={}, marker_params={},
                        verbose=True):
        """Plot the TPR against the mean false positives at each threshold
        (vip_tpu roc.py:201)."""
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=figsize, dpi=dpi)
        ax = fig.add_subplot(111)
        for m in self.methods:
            tpr = np.asarray(m["detections"], dtype=float).mean(axis=0)
            mean_fps = np.asarray(m["fps"], dtype=float).mean(axis=0)
            ax.plot(mean_fps, tpr, "--", color=m["color"], **line_params)
            ax.plot(mean_fps, tpr, m["symbol"], color=m["color"],
                    label=m["name"], **marker_params)
        if xlog:
            ax.set_xscale("symlog")
        ax.set_ylim(ymin, ymax)
        if xmin is not None or xmax is not None:
            ax.set_xlim(xmin, xmax)
        ax.set_xlabel("Full-frame mean FPs")
        ax.set_ylabel("TPR")
        ax.legend(loc=legend_loc, prop={"size": legend_size})
        if save_plot:
            fig.savefig(save_plot if isinstance(save_plot, str)
                        else "roc_curve.pdf", dpi=dpi)
        plt.show()


def compute_binary_map(frame, thresholds, injections, fwhm, npix=1,
                       overlap_threshold=0.7, max_blob_fact=2, plot=False,
                       debug=False):
    """Binary maps of a detection map at each threshold, with the number
    of detected injections and of false positives at each (vip_tpu
    roc.py:235; same parameters and returns). Each blob is compared with
    each injection's disk inside the blob's bounding box, and each disk is
    drawn once: the counts are vip_tpu's."""
    frame = _host(frame)
    injection_masks = {}

    def _injection_mask(iinj, injection):
        if iinj not in injection_masks:
            if len(injections[0]) > 0:
                mask = get_circle(np.ones(frame.shape), radius=fwhm,
                                  cy=injection[1], cx=injection[0],
                                  mode="mask").astype(bool)
            else:
                mask = np.zeros(frame.shape, dtype=bool)
            injection_masks[iinj] = (mask, mask.sum())
        return injection_masks[iinj]

    def _overlap_injection_blob(iinj, injection, blob_mask, box, area):
        injection_mask, injection_area = _injection_mask(iinj, injection)
        intersection = injection_mask[box] & blob_mask
        smallest_area = min(np.int64(area), injection_area)
        return intersection.sum() / smallest_area

    list_detections, list_fps, list_binmaps = [], [], []
    sizey, sizex = frame.shape
    cy, cx = frame_center(frame)
    npix_circ_aperture = get_circle(frame, radius=fwhm, cy=cy, cx=cx,
                                    mode="val").shape[0]
    injections = np.asarray(injections)
    if injections.ndim == 1:
        injections = np.array([injections])

    for ithr, threshold in enumerate(thresholds):
        if debug:
            print("\nprocessing threshold #{}: {}".format(ithr + 1,
                                                          threshold))
        segments = detect_sources(frame, threshold, npix, connectivity=4)
        if segments is None:
            list_detections.append(0)
            list_binmaps.append(np.zeros_like(frame))
            list_fps.append(0)
            continue
        binmap = segments.data != 0
        detections = 0
        fps = 0
        for segment in segments.segments:
            box = segments.slices[segment.label - 1]
            blob_mask = segments.data[box] == segment.label
            blob_area = segment.area
            for iinj, injection in enumerate(injections):
                if len(injections[0]) > 0:
                    if injection[0] > sizex or injection[1] > sizey:
                        raise ValueError("Wrong coordinates in "
                                         "`injections`")
                if blob_area > max_blob_fact * npix_circ_aperture:
                    fps += blob_area / npix_circ_aperture
                    break
                if _overlap_injection_blob(iinj, injection, blob_mask, box,
                                           blob_area) > overlap_threshold:
                    detections += 1
                    break
            else:
                fps += 1
        list_detections.append(detections)
        list_binmaps.append(binmap)
        list_fps.append(np.round(fps).astype(int).item())

    if plot:
        import matplotlib.pyplot as plt

        nmaps = max(len(list_binmaps), 1)
        fig, axes = plt.subplots(1, nmaps, figsize=(3 * nmaps, 3),
                                 squeeze=False)
        fig.suptitle("Final binary maps")
        for k, bmap in enumerate(list_binmaps):
            ax = axes[0, k]
            ax.imshow(bmap, origin="lower", cmap="binary",
                      interpolation="nearest")
            ax.set_title(f"thr={thresholds[k]:.1f} "
                         f"({list_detections[k]} det, {list_fps[k]} fps)",
                         fontsize=8)
            for inj in injections:
                if len(inj) > 0:
                    ax.add_patch(plt.Circle((inj[0], inj[1]), radius=fwhm,
                                            color="deepskyblue", fill=False,
                                            alpha=0.8))
            ax.set_axis_off()
        plt.show()
    return list_detections, list_fps, list_binmaps


def _create_synt_cube(cube, psf, ang, plsc, dist, flux, theta=None,
                      verbose=False, rng=None):
    """``cube`` with one companion injected (host float64; vip_tpu
    roc.py:327). With no ``theta`` the angle is drawn from ``rng``, or
    from numpy's global state reseeded from the system, as vip_tpu does."""
    centy_fr, centx_fr = frame_center(cube[0])
    if theta is None:
        if rng is None:
            np.random.seed()
            rng = np.random
        theta = rng.randint(0, 360)
    posy = dist * np.sin(np.deg2rad(theta)) + centy_fr
    posx = dist * np.cos(np.deg2rad(theta)) + centx_fr
    if verbose:
        print("Theta:", theta)
        print("Flux_inj:", flux)
    cubefc = cube_inject_companions(cube, psf, ang, flevel=flux, plsc=plsc,
                                    rad_dists=[dist], n_branches=1,
                                    theta=theta, verbose=verbose)
    return cubefc, posx, posy

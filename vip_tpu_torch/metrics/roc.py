"""Detection maps for ROC curves (port of ``detect_sources`` and
``compute_binary_map`` of ``vip_tpu.metrics.roc``; host numpy and scipy,
as in vip_tpu). ``EvalRoc`` drives ``PostProc`` objects and waits for
ROADMAP Queue 1, slice 10."""

import numpy as np
from scipy import ndimage

from ..fm.fakecomp import _host
from ..var.coords import frame_center
from ..var.shapes import get_circle

__all__ = ["detect_sources", "compute_binary_map"]


class _Segment:
    def __init__(self, label, area):
        self.label = label
        self.area = area


class _SegmentationImage:
    """Labelled array and the area of each label (the part of photutils'
    SegmentationImage that ``compute_binary_map`` reads)."""

    def __init__(self, data):
        self.data = data
        labels = np.unique(data)
        self.segments = [_Segment(int(lab), int((data == lab).sum()))
                         for lab in labels[labels != 0]]


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
    out = np.zeros_like(labeled)
    nxt = 1
    for lab in range(1, nlab + 1):
        blob = labeled == lab
        if blob.sum() >= npix:
            out[blob] = nxt
            nxt += 1
    if nxt == 1:
        return None
    return _SegmentationImage(out)


def compute_binary_map(frame, thresholds, injections, fwhm, npix=1,
                       overlap_threshold=0.7, max_blob_fact=2, plot=False,
                       debug=False):
    """Binary maps of a detection map at each threshold, with the number
    of detected injections and of false positives at each (vip_tpu
    roc.py:235; same parameters and returns)."""
    frame = _host(frame)

    def _overlap_injection_blob(injection, fwhm, blob_mask):
        if len(injections[0]) > 0:
            injection_mask = get_circle(np.ones_like(blob_mask, dtype=float),
                                        radius=fwhm, cy=injection[1],
                                        cx=injection[0],
                                        mode="mask").astype(bool)
        else:
            injection_mask = np.zeros_like(blob_mask)
        intersection = injection_mask & blob_mask
        smallest_area = min(blob_mask.sum(), injection_mask.sum())
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
            blob_mask = segments.data == segment.label
            blob_area = segment.area
            for injection in injections:
                if len(injections[0]) > 0:
                    if injection[0] > sizex or injection[1] > sizey:
                        raise ValueError("Wrong coordinates in "
                                         "`injections`")
                if blob_area > max_blob_fact * npix_circ_aperture:
                    fps += blob_area / npix_circ_aperture
                    break
                if _overlap_injection_blob(injection, fwhm,
                                           blob_mask) > overlap_threshold:
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

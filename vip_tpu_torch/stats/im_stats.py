"""Image statistics: the average radial profile and a frame's summary
(port of ``vip_tpu.stats.im_stats``). The reductions run on the frame's
device; pandas (the profile's table) and matplotlib (``plot=True``) are
imported only where they are used."""

import numpy as np
import torch

from ..config.device import as_tensor
from ..config.utils_conf import check_array
from ..var.coords import frame_center
from ..var.shapes import mask_circle
from .clip_sigma import _median_all

__all__ = ["frame_histo_stats", "frame_average_radprofile"]


def frame_average_radprofile(frame, sep=1, init_rad=None,
                             subtr_profile=False, plot=True):
    """Average radial profile of a frame over integer radii from the
    center, every ``sep`` px from ``init_rad`` (vip_tpu im_stats.py:12),
    one weighted ``bincount`` on the frame's device. Returns a pandas
    table (rad, radprof, npx), and with ``subtr_profile`` also the frame
    minus its profile (a tensor, masked inside ``init_rad`` when it is
    over 1)."""
    import pandas as pd

    check_array(frame, dim=2)
    fr = as_tensor(frame)
    cy, cx = frame_center(fr)
    init_rad = 1 if init_rad is None else init_rad
    x, y = np.indices(tuple(fr.shape))
    r = torch.as_tensor(np.hypot(x - cx, y - cy).astype(int),
                        device=fr.device)
    npx_per_rad = torch.bincount(r.reshape(-1))
    radprofile = torch.bincount(r.reshape(-1), fr.reshape(-1)) / npx_per_rad
    radists = np.arange(init_rad + 1, int(cy), sep) - 1
    prof = radprofile.cpu().numpy()
    df = pd.DataFrame({"rad": radists, "radprof": prof[radists],
                       "npx": npx_per_rad.cpu().numpy()[radists]})
    if plot:
        import matplotlib.pyplot as plt

        plt.figure()
        plt.plot(radists, prof[radists], ".-", alpha=0.6)
        plt.grid(which="both", alpha=0.4)
        plt.xlabel("Pixels")
        plt.ylabel("Counts")
    if subtr_profile:
        subtr_frame = fr - radprofile[r]
        if init_rad > 1:
            subtr_frame = mask_circle(subtr_frame, radius=init_rad)
        return df, subtr_frame
    return df


def frame_histo_stats(image_array, plot=True):
    """(mean, median, std, max, min) of a frame's values, the standard
    deviation with ddof 0 and the median numpy's (vip_tpu im_stats.py:47),
    as host floats; ``plot`` shows the frame and its histogram
    (matplotlib, imported only then)."""
    vector = as_tensor(image_array).reshape(-1)
    mean, median = float(vector.mean()), float(_median_all(vector))
    std = float(vector.std(correction=0))
    maxim, minim = float(vector.max()), float(vector.min())
    if plot:
        import matplotlib.pyplot as plt

        host = vector.cpu().numpy()
        _, axes = plt.subplots(nrows=1, ncols=2, figsize=(10, 4))
        axes[0].imshow(host.reshape(tuple(image_array.shape)),
                       origin="lower", interpolation="nearest")
        axes[1].hist(host, bins=int(np.sqrt(host.size)))
        plt.show()
    return mean, median, std, maxim, minim

"""Frame and cube cropping (port of the part of
``vip_tpu.preproc.cosmetics`` that injection and the contrast curves
need: ``frame_crop`` and ``cube_crop_frames``). A crop is an index
operation: numpy input gives a numpy view, a tensor a tensor view on its
own device. The rest of the module waits for ROADMAP Queue 1, slice 8."""

from ..var.coords import frame_center
from ..var.shapes import get_square

__all__ = ["frame_crop", "cube_crop_frames"]


def cube_crop_frames(array, size, xy=None, force=False, verbose=True,
                     full_output=False):
    """Crop the frames of a 3d or 4d cube to ``size`` px around ``xy``
    (x, y) or the frame center (vip_tpu cosmetics.py:15). Unless
    ``force``, the size takes the parity of the frames. With
    ``full_output`` also the (cenx, ceny) of the crop."""
    if array.ndim == 3:
        temp_fr = array[0]
    elif array.ndim == 4:
        temp_fr = array[0, 0]
    else:
        raise TypeError("`Array` is not a cube (3d or 4d numpy.ndarray)")

    if temp_fr.shape[0] == size and temp_fr.shape[1] == size:
        if verbose:
            print("Frame size already matches crop size. No cropping needed.")
        if full_output:
            ceny, cenx = frame_center(temp_fr)
            return array, cenx, ceny
        return array

    if xy is not None:
        cenx, ceny = xy
    else:
        ceny, cenx = frame_center(temp_fr)
    _, y0, x0 = get_square(temp_fr, size, y=ceny, x=cenx, position=True,
                           force=force, verbose=verbose)
    if not force:
        if temp_fr.shape[0] % 2 == 0:
            if size % 2 != 0:
                size += 1
        elif size % 2 == 0:
            size += 1
    y1 = int(y0 + size)
    x1 = int(x0 + size)
    array_out = array[..., y0:y1, x0:x1]
    if verbose:
        print(f"New shape: {tuple(array_out.shape)}")
    if full_output:
        return array_out, cenx, ceny
    return array_out


def frame_crop(array, size, xy=None, force=False, verbose=True):
    """Square subframe of ``size`` px around ``xy`` (x, y) or the frame
    center (vip_tpu cosmetics.py:63)."""
    if array.ndim != 2:
        raise TypeError("`Array` is not a frame or 2d array")
    if array.shape[0] == size and array.shape[1] == size:
        if verbose:
            print("Frame size already matches crop size. No cropping needed.")
        return array
    if not xy:
        ceny, cenx = frame_center(array)
    else:
        cenx, ceny = xy
    array_view = get_square(array, size, ceny, cenx, force=force,
                            verbose=verbose)
    if verbose:
        print(f"New shape: {tuple(array_view.shape)}")
    return array_view

"""Sub-pixel shifts of frames and cubes (port of ``frame_shift`` and
``cube_shift`` of ``vip_tpu.preproc.recentering``, imlibs 'vip-fft' and
'ndimage-fourier').

'vip-fft' runs ``ops.fft.fourier_shift_batch`` (VIP's padded shift),
'ndimage-fourier' ``ops.fft.cyclic_fourier_shift`` (scipy's cyclic
``fourier_shift`` of the ``fftn``, no pad: the two give different pixels),
both on the tensor's device (numpy input goes to the default device), and
return tensors. The other imlibs (scipy's interpolating shift, OpenCV)
and the recentering routines wait for ROADMAP Queue 1, slice 8.
"""

import numpy as np

from ..config.device import as_tensor
from ..config.utils_conf import check_array
from ..ops.fft import cyclic_fourier_shift, fourier_shift, fourier_shift_batch

__all__ = ["frame_shift", "cube_shift"]


def _only_fft(imlib):
    if imlib not in ("vip-fft", "ndimage-fourier"):
        raise NotImplementedError(
            f"shifts with imlib {imlib!r} are not ported yet (only "
            "'vip-fft' and 'ndimage-fourier'; ROADMAP.md, Queue 1, slice 8)")


def frame_shift(array, shift_y, shift_x, imlib="vip-fft",
                interpolation="lanczos4", border_mode="reflect"):
    """Shift a 2d frame by (shift_y, shift_x) px (vip_tpu
    recentering.py:26): 'vip-fft' with VIP's per-call pad margin
    ceil(max|shift|), 'ndimage-fourier' cyclic."""
    check_array(array, dim=2)
    _only_fft(imlib)
    if imlib == "ndimage-fourier":
        return cyclic_fourier_shift(array, float(shift_y), float(shift_x))
    npad = int(np.ceil(np.amax(np.abs([float(shift_y), float(shift_x)]))))
    return fourier_shift(as_tensor(array), shift_y, shift_x, npad)


def cube_shift(cube, shift_y, shift_x, imlib="vip-fft",
               interpolation="lanczos4", border_mode="reflect", nproc=None):
    """Shift every frame of a cube by a scalar or per-frame shift
    (vip_tpu recentering.py:74). 'vip-fft': frames are grouped by their
    own pad margin ceil(max|shift|), as ``frame_shift`` pads each call,
    and each group is one batched shift; 'ndimage-fourier': one batched
    cyclic shift."""
    check_array(cube, dim=3)
    _only_fft(imlib)
    cube = as_tensor(cube)
    n = cube.shape[0]
    shift_y = np.broadcast_to(np.asarray(shift_y, float), (n,)).copy()
    shift_x = np.broadcast_to(np.asarray(shift_x, float), (n,)).copy()
    if imlib == "ndimage-fourier":
        return cyclic_fourier_shift(cube, shift_y, shift_x)
    npads = np.ceil(np.maximum(np.abs(shift_y), np.abs(shift_x))).astype(int)
    out = None
    for npad in np.unique(npads):
        sel = np.nonzero(npads == npad)[0]
        res = fourier_shift_batch(cube[sel], shift_y[sel], shift_x[sel],
                                  int(npad))
        if out is None:
            out = res.new_empty((n,) + tuple(res.shape[1:]))
        out[sel] = res
    return out

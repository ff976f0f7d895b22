"""Array checks and the task map (port of the part of
``vip_tpu.config.utils_conf`` that the ported modules call:
``check_array``, ``frame_or_shape``, ``pool_map``, ``iterable``)."""

import numpy as np
import torch

sep = "-" * 80

__all__ = ["sep", "check_array", "frame_or_shape", "pool_map", "iterable"]


def check_array(input_array, dim, msg=None):
    """Check the dimensionality of an input array or tensor.

    ``dim`` may be an int or a tuple of accepted ndims; 1d inputs may be
    a list or tuple as well (vip_tpu utils_conf.py:46).
    """
    if msg is None:
        msg = "Input array"
    dims = (dim,) if isinstance(dim, (int, np.integer)) \
        else tuple(int(d) for d in dim)
    if 1 in dims and isinstance(input_array, (list, tuple)):
        input_array = np.asarray(input_array)
    if not isinstance(input_array, (np.ndarray, torch.Tensor)) \
            or input_array.ndim not in dims:
        dim_names = {1: "1d", 2: "2d", 3: "3d", 4: "4d"}
        wanted = " or ".join(dim_names.get(d, f"{d}d") for d in dims)
        raise TypeError(f"`{msg}` must be a {wanted} numpy ndarray or "
                        "torch tensor")
    return input_array


def frame_or_shape(data):
    """A 2d frame as it is (numpy or tensor), or a host frame of zeros for a
    shape tuple (vip_tpu utils_conf.py:82)."""
    if isinstance(data, tuple):
        return np.zeros(data)
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    if data.ndim != 2:
        raise TypeError("`data` must be a frame or a shape tuple")
    return data


class _Iterable:
    """Marker of the ``pool_map`` arguments that vary from task to task."""

    def __init__(self, it):
        self.it = it


def iterable(v):
    """Mark ``v`` as the sequence ``pool_map`` maps over."""
    return _Iterable(v)


def pool_map(nproc, fkt, *args, msg=None, verbose=True,
             progressbar_single=False, **kwargs):
    """``fkt`` over the elements of the ``iterable``-marked arguments,
    the others passed whole, and ``kwargs`` to every call (vip_tpu
    utils_conf.py:108, which dropped them). The calls run one after
    another in this process: a forked worker cannot use the parent's CUDA
    context, and the heavy work of each call is on the card already.
    ``nproc`` is accepted and changes nothing, results included."""
    iterables = [a.it for a in args if isinstance(a, _Iterable)]
    if not iterables:
        return [fkt(*args, **kwargs)]
    if verbose and msg is not None:
        print(f"{msg} serially")
    return [fkt(*[a.it[i] if isinstance(a, _Iterable) else a for a in args],
                **kwargs)
            for i in range(len(iterables[0]))]

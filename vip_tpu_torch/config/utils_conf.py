"""Array checks (port of ``vip_tpu.config.utils_conf``, the part ``pca``
calls)."""

import numpy as np
import torch

sep = "-" * 80

__all__ = ["sep", "check_array"]


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

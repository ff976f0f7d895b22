"""Hand-over from vip_tpu-style numpy inputs to the port's tensors.

- :func:`params_from_numpy` turns a vip_tpu ``PCA_Params`` (or any object
  with the same fields) into the port's ``PCA_Params``: numpy arrays become
  tensors, enums map by value onto the port's enums of the same name, and
  strings and scalars pass through.
- :func:`draws_from_numpy` turns a random draw made elsewhere (such as
  vip_tpu's randsvd sketch, ``jax.random.normal`` at vip_tpu
  ops/linalg.py:65) into the ``omega`` argument of
  ``ops.linalg.randomized_svd``/``svd_top``/``project_subtract``, so two
  implementations can be compared on the same draw.

Neither imports vip_tpu or jax: the objects are read by their fields.
"""

import dataclasses
from enum import Enum

import numpy as np

from .config import paramenum
from .config.device import as_tensor

__all__ = ["params_from_numpy", "draws_from_numpy"]


def _convert(value, device, dtype):
    if isinstance(value, Enum):
        return getattr(paramenum, type(value).__name__)(value.value)
    if isinstance(value, np.ndarray):
        if value.dtype.kind in "fiu":
            return as_tensor(value, device, dtype)
    return value


def params_from_numpy(params, device=None, dtype=None):
    """The port's ``PCA_Params`` with the fields of ``params``.

    Numpy arrays go to ``device`` (default: the device of
    ``vip_tpu_torch.set_device``) in ``dtype`` (default: the device
    policy's working dtype); fields the port's class has and ``params``
    lacks keep their defaults.
    """
    from .psfsub.pca_fullfr import PCA_Params

    kwargs = {}
    for field in dataclasses.fields(PCA_Params):
        if hasattr(params, field.name):
            kwargs[field.name] = _convert(getattr(params, field.name),
                                          device, dtype)
    return PCA_Params(**kwargs)


def draws_from_numpy(draw, device=None, dtype=None):
    """A random draw (numpy array) as the ``omega`` tensor of the port's
    randomized SVD, on ``device`` in ``dtype`` (device policy defaults)."""
    return as_tensor(np.array(draw), device, dtype)

"""Hand-over from vip_tpu-style numpy inputs to the port's tensors.

- :func:`params_from_numpy` turns a vip_tpu ``PCA_Params``,
  ``PCA_ANNULAR_Params``, ``MEDIAN_SUB_Params`` or ``XLOCI_Params`` (or
  any object with the same fields; 4-d cubes and ``scale_list``
  included) into the port's class of the same name: numpy arrays become
  tensors, enums map by value onto the port's enums of the same name, and
  strings, tuples and scalars pass through.
- :func:`draws_from_numpy` turns a random draw made elsewhere (such as
  vip_tpu's randsvd sketch, ``jax.random.normal`` at vip_tpu
  ops/linalg.py:65) into the ``omega`` argument of
  ``ops.linalg.randomized_svd``/``svd_top``/``project_subtract``, so two
  implementations can be compared on the same draw.
- :func:`dataset_from_numpy` turns a vip_tpu ``Dataset`` (or any object
  with its fields) into the port's ``objects.Dataset``, its cubes and
  PSFs on the device.

None imports vip_tpu or jax: the objects are read by their fields.
"""

import dataclasses
from enum import Enum

import numpy as np

from .config import paramenum
from .config.device import as_tensor

__all__ = ["params_from_numpy", "draws_from_numpy", "dataset_from_numpy"]


def _convert(value, device, dtype):
    if isinstance(value, Enum):
        return getattr(paramenum, type(value).__name__)(value.value)
    if isinstance(value, np.ndarray):
        if value.dtype.kind in "fiu":
            return as_tensor(value, device, dtype)
    return value


def params_from_numpy(params, device=None, dtype=None):
    """The port's ``PCA_ANNULAR_Params``, ``MEDIAN_SUB_Params`` or
    ``XLOCI_Params`` for an object of a class of that name, else the
    port's ``PCA_Params``, with the fields of ``params``.

    Numpy arrays go to ``device`` (default: the device of
    ``vip_tpu_torch.set_device``) in ``dtype`` (default: the device
    policy's working dtype); fields the port's class has and ``params``
    lacks keep their defaults.
    """
    from .psfsub.loci import XLOCI_Params
    from .psfsub.medsub import MEDIAN_SUB_Params
    from .psfsub.pca_fullfr import PCA_Params
    from .psfsub.pca_local import PCA_ANNULAR_Params

    classes = {c.__name__: c for c in (PCA_ANNULAR_Params, MEDIAN_SUB_Params,
                                       XLOCI_Params)}
    cls = classes.get(type(params).__name__, PCA_Params)
    kwargs = {}
    for field in dataclasses.fields(cls):
        if hasattr(params, field.name):
            kwargs[field.name] = _convert(getattr(params, field.name),
                                          device, dtype)
    return cls(**kwargs)


def draws_from_numpy(draw, device=None, dtype=None):
    """A random draw (numpy array) as the ``omega`` tensor of the port's
    randomized SVD, on ``device`` in ``dtype`` (device policy defaults)."""
    return as_tensor(np.array(draw), device, dtype)


def dataset_from_numpy(ds, device=None, dtype=None):
    """The port's ``Dataset`` with the fields of ``ds`` (``cube``,
    ``cuberef``, ``angles``, ``wavelengths``, ``psf``, ``psfn``, ``fwhm``,
    ``px_scale``, ``injections_yx``; a missing field is None).

    The cube, the reference cube and the PSFs go to ``device`` (default:
    the device of ``vip_tpu_torch.set_device``) in ``dtype`` (default: the
    device policy's working dtype); the angles and wavelengths stay host
    numpy, and the injections a list."""
    from .objects.dataset import Dataset

    def field(name):
        return getattr(ds, name, None)

    def placed(name):
        value = field(name)
        return None if value is None else as_tensor(np.asarray(value),
                                                    device, dtype)

    out = Dataset(cube=placed("cube"), angles=field("angles"),
                  wavelengths=field("wavelengths"), fwhm=field("fwhm"),
                  px_scale=field("px_scale"), psf=placed("psf"),
                  psfn=placed("psfn"), cuberef=placed("cuberef"))
    if field("injections_yx") is not None:
        out.injections_yx = list(field("injections_yx"))
    return out

"""vip_tpu_torch — the PyTorch/CUDA port of vip_tpu.

Same layout and public names as ``vip_tpu``; plain functions on tensors
with an explicit device (:func:`set_device`) and explicit
``torch.Generator`` draws. Numpy input runs on the CUDA card unless the
caller asks for the CPU (``set_device("cpu")``). The hot kernels (the
FFT-shear rotations and the radix-select median) are CUDA C++ for Hopper
under ``csrc/``, built with nvcc at their first launch (``_build.py``);
every kernel has a plain PyTorch version beside it, which CPU tensors
use. Subpackages load lazily.
"""

__version__ = "0.1.0"

_SUBPACKAGES = ("config", "var", "preproc", "ops", "psfsub", "metrics", "fm",
                "fits", "greedy", "invprob", "stats", "objects")

from .config.device import get_device, set_device  # noqa: E402


def __getattr__(name):
    if name in _SUBPACKAGES:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBPACKAGES))

"""Device and dtype policy of the port.

- Every op runs on the device of the tensor it is given.
- Numpy input to the public functions (``pca``, ``median_sub``,
  ``cube_derotate``, ``snrmap``, ...) goes to the device chosen with
  :func:`set_device`. The default is ``"cuda"``: the entry points run on
  the card unless the caller asks for the CPU with ``set_device("cpu")``.
  With no card and no such call, numpy input raises; nothing falls back to
  the CPU, and nothing picks a device by probing.
- On CUDA the work runs in float32/complex64 (numpy float64 input is cast
  down), as vip_tpu ran float32 on its accelerator.
- On CPU numpy float64 stays float64/complex128: the parity mode the tests
  hold against vip_tpu with x64 enabled.
"""

import numpy as np
import torch

__all__ = ["set_device", "get_device", "as_tensor", "work_dtype"]

# The Gram matrix and the PCA projections must be true float32 products:
# TF32 keeps 10 mantissa bits (about three decimal digits), while the
# residual frame is a small difference of large products (cube minus its
# low-rank reconstruction). PyTorch's default is already False; set it
# explicitly so that a caller who flipped it globally does not silently
# change the port's numbers.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_device = torch.device("cuda")


def set_device(device):
    """Choose the device that numpy input goes to (``"cpu"``, ``"cuda"``,
    ``"cuda:1"``, or a ``torch.device``). Returns the device."""
    global _device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"set_device({device!r}): CUDA is not available")
    _device = dev
    return _device


def get_device():
    """The device numpy input goes to (see :func:`set_device`). Raises if
    it is a CUDA device and no card is present."""
    if _device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vip_tpu_torch runs numpy input on the CUDA card by default, and "
            "CUDA is not available here: call vip_tpu_torch.set_device(\"cpu\")"
            " to run on the CPU (float64 parity mode), or pass tensors")
    return _device


def work_dtype(dtype, device):
    """Real working dtype for data of ``dtype`` on ``device``: float32 on
    CUDA, otherwise float64 unless the data is already float32."""
    if torch.device(device).type == "cuda":
        return torch.float32
    return torch.float32 if dtype in (np.float32, torch.float32) \
        else torch.float64


def as_tensor(x, device=None, dtype=None):
    """Tensor view of ``x`` under the policy above.

    A tensor keeps its device and dtype unless ``device`` or ``dtype`` is
    given. Numpy arrays and lists go to ``device`` (default
    :func:`get_device`) in :func:`work_dtype` unless ``dtype`` is given.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    x = np.asarray(x)
    dev = torch.device(device) if device is not None else get_device()
    if dtype is None:
        dtype = work_dtype(x.dtype.type if x.dtype.kind == "f"
                           else np.float64, dev)
    return torch.as_tensor(x, dtype=dtype, device=dev)

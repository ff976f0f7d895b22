"""Exact per-pixel median along the frame axis: CUDA kernel H1 and its
plain PyTorch version.

H1 (``csrc/nanmedian.cu``) replaces vip_tpu's Pallas TPU kernel
``nanmedian_axis0`` (vip_tpu/ops/pallas_median.py:103-127), with the same
signature and semantics: NaNs are ignored and an all-NaN pixel gives NaN
(``propagate=True``: any NaN gives NaN), and an even count averages the
two middle values in float32. It stages the order-preserving uint32 key
of each value in shared memory (hence at most 3600 frames) and selects
the lower and upper middle keys there, with one of two bodies chosen by
the frame count alone (:func:`median_body`): up to 1650 frames, four
8-bit digits top first, each from a 256-bin histogram a pixel (the keys
swept four times, the last two over those of the middle's top-digit bin
alone); above, 32 rounds of MSB-first bisection and one more sweep for
the upper middle (34 sweeps).

The plain version sorts the same keys along axis 0 (NaNs last), counts
the non-NaN values m, gathers ranks (m−1)//2 and m//2 and averages them in
the input dtype. It is bit-equal to the kernel (the key order also ranks
−0.0 below +0.0), and it does not use ``torch.nanmedian``, which returns
the lower middle of an even count.
"""

import torch

__all__ = ["nanmedian_supported", "nanmedian_axis0", "nanmedian_plain",
           "median_body"]

#: Number of H1 kernel launches since the last reset (set it to 0 to reset).
launches = 0

_INT = {torch.float32: torch.int32, torch.float64: torch.int64}
# frames whose keys fit a block's 227 KB of shared memory
# (csrc/nanmedian.cu, which asserts both): a 16-pixel tile of keys, and
# the digit body's 32-pixel tile beside its histograms and state
_MAX_FRAMES = 3600
_DIGIT_MAX_FRAMES = 1650


def nanmedian_supported(arr, ax=0):
    """Gate of H1: a 3-D float32 CUDA tensor reduced along axis 0, with
    1 to 3600 frames and fewer than 2^31 pixels."""
    return (isinstance(arr, torch.Tensor) and arr.is_cuda and ax == 0
            and arr.ndim == 3 and arr.dtype == torch.float32
            and 1 <= arr.shape[0] <= _MAX_FRAMES
            and arr.shape[1] * arr.shape[2] < 2 ** 31)


def median_body(n):
    """Which body of H1 selects the median of n frames, a pure function of
    n: "digits" (radix-256 digit histograms) for 1..1650, "bisection" for
    1651..3600, None outside the gate."""
    if not 1 <= n <= _MAX_FRAMES:
        return None
    return "digits" if n <= _DIGIT_MAX_FRAMES else "bisection"


def median_config(n):
    """H1's launch configuration for n frames, from the card without a
    launch: registers and spilled bytes a thread, blocks an SM, threads
    and dynamic shared memory a block, and the body."""
    import ctypes

    from .._build import check, load

    info = (ctypes.c_int * 6)()
    check(load().vip_nanmedian_info(n, info), "median_config")
    out = dict(zip(("registers", "spill_bytes", "blocks_per_sm", "threads",
                    "smem_bytes"), info))
    out["body"] = "digits" if info[5] else "bisection"
    return out


def nanmedian_plain(arr, ax=0, propagate=False):
    """``numpy.nanmedian(arr, axis=ax)`` (``numpy.median`` when
    ``propagate``) for float32/float64 tensors, by a sort of the
    order-preserving integer keys along ``ax``."""
    if arr.dtype not in _INT:
        raise TypeError(f"nanmedian_plain: float32 or float64, got "
                        f"{arr.dtype}")
    itype = _INT[arr.dtype]
    top = torch.iinfo(itype).max
    x = torch.movedim(arr, ax, 0)
    isnan = torch.isnan(x)
    # float bits as a signed int: negative floats flip their magnitude
    # bits so the integer order is the IEEE total order; NaNs sort last
    bits = x.contiguous().view(itype)
    keys = torch.where(bits < 0, bits ^ top, bits)
    keys = torch.where(isnan, top, keys)
    keys = torch.sort(keys, dim=0).values
    m = (~isnan).sum(dim=0)
    lo = ((m - 1).clamp(min=0) // 2)[None]
    hi = (m // 2)[None]
    v = torch.cat([keys.gather(0, lo), keys.gather(0, hi)])
    v = torch.where(v < 0, v ^ top, v).view(arr.dtype)
    med = (v[0] + v[1]) / 2
    bad = m < x.shape[0] if propagate else m == 0
    return torch.where(bad, torch.nan, med)


def nanmedian_axis0(arr, propagate=False):
    """Median along axis 0 of a 3-D float32 tensor (``nanmedian``, or
    ``median`` with ``propagate``). CPU tensors take the plain version;
    CUDA tensors launch H1 and raise on anything the kernel does not take
    (see :func:`nanmedian_supported`; the tensor must be contiguous)."""
    global launches
    if arr.device.type == "cpu":
        return nanmedian_plain(arr, 0, propagate)
    if not nanmedian_supported(arr, 0):
        raise ValueError(f"nanmedian_axis0: kernel takes a 3-D float32 CUDA "
                         f"tensor, got {arr.dtype} {tuple(arr.shape)} on "
                         f"{arr.device}")
    if not arr.is_contiguous():
        raise ValueError("nanmedian_axis0: the tensor must be contiguous")
    from .._build import check, load

    lib = load()
    n, h, w = arr.shape
    out = torch.empty((h, w), dtype=torch.float32, device=arr.device)
    with torch.cuda.device(arr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vip_nanmedian_axis0(arr.data_ptr(), out.data_ptr(), n,
                                     h * w, int(bool(propagate)), stream)
    check(rc, "nanmedian_axis0")
    launches += 1
    return out

"""The FITS data-block codec: ``fits_io.cpp`` (a multithreaded mmap
decoder and a big-endian encoder) built with g++ at its first use into
``vip_tpu_torch/_build/`` and loaded with ctypes, and its plain numpy
versions (``_decode_plain``, ``_encode_plain``), which compute the same
bits and which the tests hold it against.

The build compiles to a name of its own process, then renames the
library into place, so that processes building at once (test workers)
each load a whole library; a ``.srchash`` stamp over the source and the
flags decides whether to build again. A failed build raises with g++'s
output, and a failed decode raises with the meaning of its return code:
nothing falls back to numpy. :func:`available` only asks whether the
library builds and loads.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np
import torch

__all__ = ["load", "available", "decode", "encode"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fits_io.cpp")
_SO = os.path.join(os.path.dirname(_HERE), "_build", "libfits_io.so")
# no multiply-add fused: the scaled decode must round as numpy does
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]
_ERRORS = {-1: "the file does not open", -2: "fstat failed",
           -3: "the file is shorter than its data block",
           -4: "mmap failed", -5: "BITPIX is not 8, 16, 32, 64, -32 or -64"}

_BITPIX_DTYPE = {8: np.uint8, 16: ">i2", 32: ">i4", 64: ">i8",
                 -32: ">f4", -64: ">f8"}

_lib = None
_lock = threading.Lock()


def _src_hash():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return h.hexdigest()


def _build(digest):
    """Compile the library unless its stamp matches ``digest``."""
    stamp = _SO + ".srchash"
    if os.path.exists(_SO) and os.path.exists(stamp):
        with open(stamp) as fh:
            if fh.read().strip() == digest:
                return
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC, "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: the FITS codec needs a C++ "
                           "compiler to build") from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, _SO)      # atomic: a concurrent loader sees old or new
    with open(stamp + tmp[len(_SO):], "w") as fh:
        fh.write(digest)
    os.replace(stamp + tmp[len(_SO):], stamp)


def load():
    """The codec's ctypes library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _build(_src_hash())
            lib = ctypes.CDLL(_SO)
            for name, ptr in (("fits_decode_f32", ctypes.c_float),
                              ("fits_decode_f64", ctypes.c_double)):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_double,
                               ctypes.c_double, ctypes.POINTER(ptr)]
                fn.restype = ctypes.c_int
            lib.fits_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int]
            lib.fits_encode.restype = None
            _lib = lib
    return _lib


def available():
    """Whether the codec builds and loads (vip_tpu _native.py:94): True
    when :func:`load` returns the library, False when it raises. Nothing
    else changes: a decode or an encode still raises where it raised."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def _wire(precision):
    """The dtype the codec writes for ``precision``: float32 or float64 as
    asked, float64 for any other (then cast)."""
    precision = np.dtype(precision)
    return precision if precision in (np.float32, np.float64) \
        else np.dtype(np.float64)


def _out_buffer(out, n, dtype):
    """(numpy view, pointer) of a contiguous CPU buffer of ``n`` values of
    ``dtype``: an ndarray or a tensor (pinned or not)."""
    if isinstance(out, torch.Tensor):
        want = torch.float32 if dtype == np.float32 else torch.float64
        if out.device.type != "cpu" or out.dtype != want \
                or not out.is_contiguous() or out.numel() != n:
            raise ValueError(f"decode: `out` must be a contiguous CPU {want} "
                             f"tensor of {n} values")
        return out.numpy().reshape(-1), out.data_ptr()
    if not isinstance(out, np.ndarray) or out.dtype != dtype \
            or not out.flags.c_contiguous or out.size != n:
        raise ValueError(f"decode: `out` must be a C-contiguous {dtype} "
                         f"ndarray of {n} values")
    return out.reshape(-1), out.ctypes.data


def decode(path, offset, shape, bitpix, bscale, bzero, precision, out=None):
    """The data block of ``shape`` at byte ``offset`` of ``path``
    (big-endian, of ``bitpix``) as native ``precision`` values, scaled by
    ``bscale`` and ``bzero`` (fits_io.cpp's semantics). ``out``, a
    contiguous CPU ndarray or tensor (pinned memory too) of the right
    dtype and size, receives the values and is returned in ``shape``;
    ``out`` needs ``precision`` float32 or float64."""
    n = int(np.prod(shape)) if len(shape) else 1
    wire = _wire(precision)
    if out is None:
        buf = np.empty(n, dtype=wire)
        ptr = buf.ctypes.data
    elif wire != np.dtype(precision):
        raise ValueError("decode: `out` needs precision float32 or float64")
    else:
        buf, ptr = _out_buffer(out, n, wire)
    lib = load()
    fn = lib.fits_decode_f64 if wire == np.float64 else lib.fits_decode_f32
    ctype = ctypes.c_double if wire == np.float64 else ctypes.c_float
    rc = fn(os.fsencode(path), int(offset), n, int(bitpix), float(bscale),
            float(bzero), ctypes.cast(ptr, ctypes.POINTER(ctype)))
    if rc != 0:
        raise OSError(f"FITS decode of {path} (offset {offset}, {n} values, "
                      f"BITPIX {bitpix}) failed ({rc}): "
                      f"{_ERRORS.get(rc, 'unknown error')}")
    if out is not None:
        return out.view(tuple(shape)) if isinstance(out, torch.Tensor) \
            else out.reshape(shape)
    return buf.reshape(shape).astype(precision, copy=False)


def encode(arr):
    """Big-endian bytes (a uint8 ndarray) of a float32 or float64 array."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in (np.float32, np.float64):
        raise TypeError(f"encode: float32 or float64, not {arr.dtype}")
    out = np.empty(arr.nbytes, dtype=np.uint8)
    load().fits_encode(arr.ctypes.data, out.ctypes.data, arr.size,
                       arr.itemsize)
    return out


def _decode_plain(path, offset, shape, bitpix, bscale, bzero, precision):
    """:func:`decode` in numpy (the same bits), into a new array."""
    n = int(np.prod(shape)) if len(shape) else 1
    if bitpix not in _BITPIX_DTYPE:
        raise OSError(f"FITS decode of {path}: {_ERRORS[-5]}")
    raw = np.fromfile(path, dtype=_BITPIX_DTYPE[bitpix], count=n,
                      offset=offset)
    if raw.size < n:
        raise OSError(f"FITS decode of {path}: {_ERRORS[-3]}")
    wire = _wire(precision)
    if bscale == 1.0 and bzero == 0.0:
        data = raw.astype(wire)
    else:
        data = (bscale * raw.astype(np.float64) + bzero).astype(wire)
    return data.reshape(shape).astype(precision, copy=False)


def _encode_plain(arr):
    """:func:`encode` in numpy."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in (np.float32, np.float64):
        raise TypeError(f"encode: float32 or float64, not {arr.dtype}")
    return np.frombuffer(arr.astype(arr.dtype.newbyteorder(">")).tobytes(),
                         dtype=np.uint8)

"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with its own ``nvcc`` process for Hopper
(``sm_90a``), all started together; one more ``nvcc`` links the objects
into one shared library with a plain C interface under ``_build/``
(ignored by git), loaded with ``ctypes``. The build runs at the first
kernel launch, never at import, so the package imports on a host with no
``nvcc``; it is redone only when the sources (``*.cu`` and the ``*.cuh``
headers they share) or the flags change (a ``.srchash`` stamp, as
``vip_tpu/fits/_native.py`` does for its decoder). A failed build raises
with nvcc's output.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

__all__ = ["build", "load", "check"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")
_SO = os.path.join(_BUILD_DIR, "libvip_kernels.so")
_STAMP = _SO + ".srchash"
# no --use_fast_math: the median must keep denormals to stay bit-equal to
# its plain version
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC"]

_lib = None

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "vip_nanmedian_axis0": [_P, _P, _LL, _LL, _I, _P],
    "vip_shear_lines": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _LL, _LL, _LL, _I, _I, _LL, _LL, _LL, _I,
                        _I, _P],
    "vip_shear3": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "vip_shear3_info": [_I, _I, _P],
    "vip_nanmedian_info": [_LL, _P],
}


def _sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh")))


def _src_hash():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in _sources() + _headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return nvcc


def _check_nvcc(cmd, rc, out, err):
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}\n"
                           f"{err}")


def build():
    """Compile the kernels if the library is missing or stale. Returns the
    library's path."""
    digest = _src_hash()
    if os.path.exists(_SO) and os.path.exists(_STAMP):
        with open(_STAMP) as fh:
            if fh.read().strip() == digest:
                return _SO
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(_BUILD_DIR,
                           f"{os.path.basename(src)[:-3]}.{tag}.o")
        cmd = [nvcc, *_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
    tmp = f"{_SO}.{tag}"
    link = [nvcc, *_FLAGS, "-shared", "-o", tmp, *objs]
    try:
        for cmd, proc in procs:
            out, err = proc.communicate()
            _check_nvcc(cmd, proc.returncode, out, err)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout, proc.stderr)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, _SO)  # atomic: a concurrent loader sees old or new
    with open(_STAMP, "w") as fh:
        fh.write(digest)
    return _SO


def load():
    """The kernels' ctypes library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vip_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vip_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc, what):
    """Raise if a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        name = load().vip_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({name})")

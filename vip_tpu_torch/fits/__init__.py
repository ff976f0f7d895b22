"""FITS I/O of the port: a numpy-only copy of ``vip_tpu.fits`` (the C++
decoder stays with slice 10)."""

from .fits import *
from .headers import *

"""FITS I/O of the port: a copy of ``vip_tpu.fits`` with its native
codec (``fits_io.cpp``, built with g++ at its first use)."""

from .fits import *
from .headers import *

"""Coordinates and shapes (port of ``vip_tpu.var``, the part PCA uses)."""

from .coords import *
from .shapes import *

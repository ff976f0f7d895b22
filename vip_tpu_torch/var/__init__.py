"""Coordinates and shapes (port of the part of ``vip_tpu.var`` that PCA,
injection and the metrics use)."""

from .coords import *
from .shapes import *

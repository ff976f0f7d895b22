"""Metrics (port of the part of ``vip_tpu.metrics`` that finds a
companion: S/N, S/N maps and detection)."""

from .detection import *
from .snr_source import *

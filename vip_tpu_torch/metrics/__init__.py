"""Metrics (port of ``vip_tpu.metrics``: S/N, S/N maps and detection;
contrast and completeness curves, STIM maps and the ROC detection maps).
``EvalRoc`` waits for ROADMAP Queue 1, slice 10."""

from .completeness import *
from .contrcurve import *
from .detection import *
from .roc import *
from .snr_source import *
from .stim import *

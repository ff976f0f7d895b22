"""Preprocessing (port of ``vip_tpu.preproc``: derotation, collapse,
parallactic angles, cropping and 'vip-fft' shifts)."""

from .cosmetics import *
from .derotation import *
from .parangles import *
from .recentering import *
from .subsampling import *

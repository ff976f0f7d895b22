"""Preprocessing (port of ``vip_tpu.preproc``: derotation, collapse,
parallactic angles, cropping, 'vip-fft' shifts, rescaling and the PCA
sky subtraction)."""

from .cosmetics import *
from .derotation import *
from .parangles import *
from .recentering import *
from .subsampling import *
from .rescaling import *
from .skysubtraction import *

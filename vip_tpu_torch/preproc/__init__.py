"""Preprocessing (port of ``vip_tpu.preproc``: derotation, collapse,
parallactic angles, cropping, 'vip-fft' shifts and the recentering
routines, bad-pixel correction, bad-frame detection, rescaling and the
PCA sky subtraction)."""

from .badframes import *
from .badpixremoval import *
from .cosmetics import *
from .derotation import *
from .parangles import *
from .recentering import *
from .subsampling import *
from .rescaling import *
from .skysubtraction import *

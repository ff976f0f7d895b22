"""Preprocessing (port of ``vip_tpu.preproc``: derotation, collapse and
parallactic angles)."""

from .derotation import *
from .parangles import *
from .subsampling import *

"""Image primitives: coordinates, shapes and masks, filters, 2-d fits
(port of ``vip_tpu.var``)."""

from .coords import *
from .shapes import *
from .filters import *
from .fit_2d import *

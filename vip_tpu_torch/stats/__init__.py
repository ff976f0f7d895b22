"""Statistics: the sigma filter and clip, frame distances, region and
image statistics, background-star probability (port of
``vip_tpu.stats``)."""

from .bkg_proba import *
from .clip_sigma import *
from .distances import *
from .im_stats import *
from .utils_stats import *

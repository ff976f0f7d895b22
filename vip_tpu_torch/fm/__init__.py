"""Forward modelling (port of the part of ``vip_tpu.fm`` that injects
fake companions: ``fakecomp``, and ``utils_negfc.find_nearest``)."""

from .fakecomp import *
from .utils_negfc import *

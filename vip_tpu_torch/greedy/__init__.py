"""Greedy / iterative algorithms (port of ``vip_tpu.greedy``: GreeDS/IPCA,
INMF and IROLL). The host drives the iterations; every inner step is the
port's ``pca``, ``nmf`` or ``roll_sub`` on the cube's device."""

from .inmf_fullfr import *
from .ipca_fullfr import *
from .irollsub import *
from .utils_greedy import *

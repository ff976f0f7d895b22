"""Inverse-problem detection: ANDROMEDA [MUG09]/[CAN15], the Forward Model
Matched Filter [RUF17]/[DAH21a] and PACO [FLA18] (port of
``vip_tpu.invprob``)."""

from .andromeda import *
from .fmmf import *
from .paco import *

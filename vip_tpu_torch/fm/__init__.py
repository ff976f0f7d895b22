"""Forward modelling (port of the part of ``vip_tpu.fm`` that injects
fake companions, ``fakecomp``, and of NEGFC: ``negfc_fmerit``,
``negfc_simplex``, ``negfc_mcmc``, ``negfc_nested``,
``negfc_speckle_noise``, ``utils_mcmc`` and ``utils_negfc``)."""

from .fakecomp import *
from .negfc_fmerit import *
from .negfc_simplex import *
from .negfc_mcmc import *
from .negfc_nested import *
from .negfc_speckle_noise import *
from .utils_mcmc import *
from .utils_negfc import *

"""Forward modelling (port of ``vip_tpu.fm``): fake companions
(``fakecomp``), NEGFC (``negfc_fmerit``, ``negfc_simplex``,
``negfc_mcmc``, ``negfc_nested``, ``negfc_speckle_noise``, ``utils_mcmc``,
``utils_negfc``) and the disks: the scattered-light model
(``scattered_light_disk``), their injection (``fakedisk``) and NEGFD
(``negfd_fmerit``, ``negfd_interp``, ``negfd_simplex``,
``utils_negfd``)."""

from .fakecomp import *
from .fakedisk import *
from .negfc_fmerit import *
from .negfc_simplex import *
from .negfc_mcmc import *
from .negfc_nested import *
from .negfc_speckle_noise import *
from .negfd_fmerit import *
from .negfd_interp import *
from .negfd_simplex import *
from .utils_mcmc import *
from .utils_negfc import *
from .utils_negfd import *
from .scattered_light_disk import *

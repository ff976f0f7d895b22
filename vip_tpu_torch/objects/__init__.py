"""Object-oriented interface: Dataset/Frame containers and PostProc
algorithm objects (port of ``vip_tpu.objects``, VIP's objects/): the
dataset's cube lives on the device, and each object's ``run`` forwards
to the port's function of the same algorithm."""

from .dataset import *
from .postproc import *
from .ppandromeda import *
from .ppfmmf import *
from .ppframediff import *
from .ppllsg import *
from .pploci import *
from .ppmediansub import *
from .ppnmf import *
from .pppca import *

"""Config layer of the port: enums, parameter plumbing, device policy,
runtime utilities and the telescope constants."""

from .device import *
from .mem import *
from .param import *
from .parallel import *
from .paramenum import *
from .timing import *
from .utils_conf import *
from .utils_param import *

from . import paramenum
from . import parallel
from .paramenum import (ALGO_KEY, Adimsdi, Collapse, Imlib, Interpolation,
                        Scaling, SvdMode)

"""Config layer of the port: enums, parameter plumbing, device policy."""

from .device import *
from .mem import *
from .paramenum import *
from .timing import *
from .utils_conf import *
from .utils_param import *

from . import paramenum
from .paramenum import (ALGO_KEY, Adimsdi, Collapse, Imlib, Interpolation,
                        Scaling, SvdMode)

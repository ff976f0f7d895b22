"""PSF subtraction (port of ``vip_tpu.psfsub``: full-frame and annular
PCA)."""

from .pca_fullfr import *
from .pca_local import *
from .svd import *

"""PSF subtraction (port of ``vip_tpu.psfsub``: full-frame PCA)."""

from .pca_fullfr import *
from .svd import *

"""PSF subtraction (port of ``vip_tpu.psfsub``: full-frame, annular and
streamed PCA, the PCA grid and single-annulus PCA, median-ADI)."""

from .medsub import *
from .pca_fullfr import *
from .pca_local import *
from .svd import *
from .utils_pca import *

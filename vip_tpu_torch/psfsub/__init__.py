"""PSF subtraction (port of ``vip_tpu.psfsub``: full-frame, annular and
streamed PCA, the PCA grid and single-annulus PCA, median-ADI, full-frame
and annular NMF, LLSG, LOCI, frame differencing and roll subtraction)."""

from .framediff import *
from .llsg import *
from .loci import *
from .medsub import *
from .nmf_fullfr import *
from .nmf_local import *
from .pca_fullfr import *
from .pca_local import *
from .rollsub import *
from .svd import *
from .utils_pca import *

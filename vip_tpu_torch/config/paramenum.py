"""String-valued enums for every algorithm switch.

Same members and values as ``vip_tpu.config.paramenum`` (itself VIP's
``vip_hci.config.paramenum``), so a parameter set written for either
package means the same here. The ten SVD backends collapse onto three
torch methods (see :class:`SvdMode`).
"""

from enum import Enum

#: Key used to pass a pre-built params object through ``**kwargs``
#: (reference: config/paramenum.py:4).
ALGO_KEY = "algo_params"


class SvdMode(str, Enum):
    """SVD method switch.

    Every mode runs on the tensor's device. ``lapack``/``cupy``/``pytorch``
    map to ``torch.linalg.svd``; ``eigen``/``eigencupy``/``eigenpytorch``
    map to the covariance ``eigh`` trick; ``randsvd``/``randcupy``/
    ``randpytorch``/``arpack`` map to a randomized (power-iteration) SVD.
    """

    LAPACK = "lapack"
    ARPACK = "arpack"
    EIGEN = "eigen"
    RANDSVD = "randsvd"
    CUPY = "cupy"
    EIGENCUPY = "eigencupy"
    RANDCUPY = "randcupy"
    PYTORCH = "pytorch"
    EIGENPYTORCH = "eigenpytorch"
    RANDPYTORCH = "randpytorch"


class Scaling(str, Enum):
    TEMPMEAN = "temp-mean"
    SPATMEAN = "spat-mean"
    TEMPSTANDARD = "temp-standard"
    SPATSTANDARD = "spat-standard"


class Adimsdi(str, Enum):
    DOUBLE = "double"
    SINGLE = "single"
    SKIPADI = "skipadi"


class Imlib(str, Enum):
    """Image-transform backend. ``vip-fft`` is the exact FFT rotation."""

    OPENCV = "opencv"
    SKIMAGE = "skimage"
    NDIMAGE = "ndimage"
    VIPFFT = "vip-fft"


class Interpolation(str, Enum):
    NEARNEIG = "nearneig"
    BILINEAR = "bilinear"
    BIQUADRATIC = "biquadratic"
    BICUBIC = "bicubic"
    BIQUARTIC = "biquartic"
    BIQUINTIC = "biquintic"
    LANCZOS4 = "lanczos4"


class Collapse(str, Enum):
    MEDIAN = "median"
    MEAN = "mean"
    SUM = "sum"
    TRIMMEAN = "trimmean"
    MAX = "max"
    ABSMEAN = "absmean"
    WMEAN = "wmean"


class ReturnList(str, Enum):
    ADIMSDI_DOUBLE = "adimsdi_double"
    ADIMSDI_SINGLE_NO_GRID = "adimsdi_single_no_grid"
    ADIMSDI_SINGLE_GRID_NO_SOURCE = "adimsdi_single_grid_no_source"
    ADIMSDI_SINGLE_GRID_SOURCE = "adimsdi_single_grid_source"
    ADI_FULLFRAME_GRID = "adi_fullframe_grid"
    ADI_FULLFRAME_STANDARD = "adi_fullframe_standard"
    ADI_INCREMENTAL_BATCH = "adi_incremental_batch"
    PCA_GRID_SN = "pca_grid_sn"
    PCA_ROT_THRESH = "pca_rot_thresh"


class Metric(str, Enum):
    CITYBLOCK = "cityblock"
    COSINE = "cosine"
    EUCLIDEAN = "euclidean"
    L1 = "l1"
    L2 = "l2"
    MANHATTAN = "manhattan"
    CORRELATION = "correlation"


class LowRankMode(str, Enum):
    SVD = "svd"
    BRP = "brp"


class AutoRankMode(str, Enum):
    NOISE = "noise"
    CEVR = "cevr"


class ThreshMode(str, Enum):
    SOFT = "soft"
    HARD = "hard"


class Solver(str, Enum):
    LSTSQ = "lstsq"
    NNLS = "nnls"


class Runmode(str, Enum):
    CLASSIC = "classic"
    ANNULAR = "annular"
    GRID = "grid"
    ANNULUS = "annulus"


class HandleNeg(str, Enum):
    SUBTR_MIN = "subtr_min"
    MASK = "mask"
    NULL = "null"


class Initsvd(str, Enum):
    NNDSVD = "nndsvd"
    NNDSVDA = "nndsvda"
    RANDOM = "random"


class OptMethod(str, Enum):
    NO = "no"
    TOTAL = "total"
    LSQ = "lsq"
    L1 = "l1"


class VarEstim(str, Enum):
    FR = "fr"
    FM = "fm"
    TE = "te"

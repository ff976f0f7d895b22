"""Telescope and instrument constants (a copy of
``vip_tpu.config.param``, itself VIP's config/param.py:19-108)."""

__all__ = ["VLT_SPHERE_IFS", "VLT_SPHERE_IRDIS", "VLT_NACO", "VLT_SINFONI",
           "GPI_IFS", "LBT", "KECK_NIRC2"]

VLT_SPHERE_IFS = {
    "latitude": -24.627,
    "longitude": -70.404,
    "plsc": 0.00746,   # plate scale [arcsec]/px for IFS
    "diam": 8.2,       # telescope diameter [m]
}

VLT_SPHERE_IRDIS = {
    "latitude": -24.627,
    "longitude": -70.404,
    "plsc": 0.01225,   # plate scale [arcsec]/px for IRDIS
    "diam": 8.2,
}

VLT_NACO = {
    "latitude": -24.627,
    "longitude": -70.404,
    "plsc": 0.027190,
    "diam": 8.2,
    "lambdal": 3.8e-6,  # L-band central wavelength [m]
    "kw_categ": "HIERARCH ESO DPR CATG",
    "kw_type": "HIERARCH ESO DPR TYPE",
}

VLT_SINFONI = {
    "latitude": -24.627,
    "longitude": -70.404,
    "plsc": 0.0125,
    "diam": 8.2,
    "lambdahk": 1.95e-6,
    "lambdah": 1.65e-6,
    "lambdak": 2.166e-6,
    "kw_categ": "HIERARCH ESO DPR CATG",
    "kw_type": "HIERARCH ESO DPR TYPE",
}

GPI_IFS = {
    "latitude": -30.2417,
    "longitude": -70.747,
    "plsc": 0.014166,
    "diam": 8.1,
}

LBT = {
    "latitude": 32.70131,
    "longitude": -109.889064,
    "lambdal": 3.47e-6,
    "plsc": 0.0106,
    "diam": 8.4,
    "lst": "LBT_LST",
    "ra": "LBT_RA",
    "dec": "LBT_DEC",
    "altitude": "LBT_ALT",
    "azimuth": "LBT_AZ",
    "exptime": "EXPTIME",
    "acqtime": "ACQTIME",
    "filter": "LMIR_FW2",
}

KECK_NIRC2 = {
    "latitude": 19.82636,
    "plsc_narrow": 0.009942,
    "plsc_medium": 0.019829,
    "plsc_wide": 0.039686,
    "diam": 10.0,
    "camera_name": "CAMNAME",
}

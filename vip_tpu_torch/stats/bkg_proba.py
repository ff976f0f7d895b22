"""Background-star probability (port of ``vip_tpu.stats.bkg_proba``;
host arithmetic, as there)."""

from math import factorial

import numpy as np

__all__ = ["bkg_star_proba"]


def bkg_star_proba(n_dens, sep, n_bkg=1, unit="deg", verbose=True,
                   full_output=False):
    """Poisson probability of ``n_bkg`` or more background stars within
    ``sep`` arcsec for a density ``n_dens`` per square ``unit``; with
    ``full_output`` also the probabilities of 0..n_bkg-1 (vip_tpu
    bkg_proba.py:10)."""
    if n_bkg < 1 or not isinstance(n_bkg, int):
        raise TypeError("n_bkg should be a strictly positive integer.")
    if unit not in ("deg", "arcsec"):
        raise ValueError("unit must be 'deg' or 'arcsec'.")
    if verbose:
        print(f"Input n_dens unit: {unit}^-2")
    if unit == "deg":
        n_dens = n_dens / 3600 ** 2

    if not isinstance(sep, float):
        if not isinstance(sep, np.ndarray):
            raise TypeError("sep can only be a float or a np 1d array")
        if sep.ndim != 1 or sep.shape[0] != n_bkg:
            raise TypeError("if sep is a np array, its len should be "
                            "n_bkg")
        sep = np.amax(sep)

    # Poisson pmf terms for 0..n_bkg-1 stars in the disk of area B
    lam = n_dens * np.pi * sep ** 2
    probas = np.array([np.exp(-lam) * lam ** i / float(factorial(i))
                       for i in range(n_bkg)])
    if verbose:
        for i, p_i in enumerate(probas):
            print(f"Proba of having {i:.0f} bkg star in a disk of "
                  f"{sep:.2g}'' radius: {p_i * 100:.4g}%")
    proba = 1 - np.sum(probas)
    if verbose:
        print(f"Proba of having {n_bkg:.0f} bkg star or more in a disk of "
              f"{sep:.2g}'' radius: {proba * 100:.4g}%")
    return (proba, probas) if full_output else proba

"""MCMC convergence diagnostics (port-owned copy of
``vip_tpu.fm.utils_mcmc``: the Gelman-Rubin R-hat and the emcee
integrated autocorrelation time of reference vip_hci/fm/utils_mcmc.py),
host numpy over whole walker batches.
"""

import numpy as np

__all__ = ["gelman_rubin", "gelman_rubin_from_chain", "autocorr",
           "autocorr_test"]


def gelman_rubin(x):
    """Gelman-Rubin R-hat over the last two axes (..., n_chains, n_samples).

    R-hat = (pooled variance + between/m) / within, with the pooled
    variance mixing the within- and between-chain estimates
    (reference utils_mcmc.py:18-71).
    """
    x = np.asarray(x, dtype=float)
    if x.ndim < 2 or x.shape[-2] < 2:
        raise ValueError("Gelman-Rubin diagnostic requires multiple chains "
                         "of the same length")
    m, n = x.shape[-2:]
    chain_means = x.mean(axis=-1)
    between = chain_means.var(axis=-1, ddof=1)  # B/n
    within = x.var(axis=-1, ddof=1).mean(axis=-1)  # W
    pooled = within * (n - 1) / n + between
    return (pooled + between / m) / within


def gelman_rubin_from_chain(chain, burnin):
    """Per-parameter R-hat from a (walkers, steps, ndim) chain, comparing
    the first and last quarter of the post-burnin samples (reference
    utils_mcmc.py:74-103)."""
    chain = np.asarray(chain, dtype=float)
    nsteps = chain.shape[1]
    start = int(np.floor(burnin * nsteps))
    quarter = int(np.floor((1 - burnin) * nsteps * 0.25))
    # flatten walkers within each quarter -> two pseudo-chains per param
    head = chain[:, start:start + quarter]
    tail = chain[:, start + 3 * quarter:start + 4 * quarter]
    ndim = chain.shape[2]
    head = head.transpose(2, 0, 1).reshape(ndim, -1)
    tail = tail.transpose(2, 0, 1).reshape(ndim, -1)
    return gelman_rubin(np.stack([head, tail], axis=1))


def _next_pow_two(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def autocorr_func_1d(x, norm=True):
    """Autocorrelation function of one (or a batch of) series via FFT
    (the emcee recipe; reference utils_mcmc.py:113-128)."""
    x = np.asarray(x, dtype=float)
    was_1d = x.ndim == 1
    x = np.atleast_2d(x)
    n = x.shape[-1]
    size = 2 * _next_pow_two(n)
    centered = x - x.mean(axis=-1, keepdims=True)
    spec = np.fft.rfft(centered, size, axis=-1)
    acf = np.fft.irfft(spec * np.conj(spec), size, axis=-1)[..., :n]
    acf /= 4 * _next_pow_two(n)
    if norm:
        acf = acf / acf[..., :1]
    return acf[0] if was_1d else acf


def _auto_window(taus, c):
    """Sokal auto-window: first lag M with M >= c * tau(M)."""
    crossed = np.arange(len(taus)) >= c * taus
    if crossed.all():
        return len(taus) - 1
    if not crossed.any():
        return 0
    return int(np.argmax(crossed))


def autocorr(y, c=5.0):
    """Integrated autocorrelation time of a (walkers, steps) chain: mean
    of the per-walker normalized ACFs, windowed a la Sokal."""
    y = np.asarray(y, dtype=float)
    mean_acf = autocorr_func_1d(y).reshape(y.shape[0], -1).mean(axis=0)
    taus = 2.0 * np.cumsum(mean_acf) - 1.0
    return taus[_auto_window(taus, c)]


def autocorr_test(chain):
    """tau/N — the chain is considered converged when below 1/ac_c."""
    return autocorr(chain) / chain.shape[1]


def next_pow_two(n):
    """Smallest power of two >= n (reference fm/utils_mcmc.py:106-110)."""
    return _next_pow_two(n)


def auto_window(taus, c):
    """Sokal auto-windowing for the integrated autocorrelation time
    (reference fm/utils_mcmc.py:131-135)."""
    return _auto_window(taus, c)

"""Synthetic observing sequences, made on the device from the seed.

One generator for every configuration file. A sequence is a (frames, y,
x) ADI cube, or a (channels, frames, y, x) ADI+mSDI cube when the
configuration lists wavelengths, with:

- a star: a Gaussian core and a Moffat-like halo, the core's share
  growing with wavelength as a Strehl ratio does;
- quasi-static speckles fixed in the pupil frame: one static pattern and
  ``modes`` slowly evolving ones ("breathing"), each a band-limited random
  field modulating the halo, with its own smooth random time series; the
  evolving ones' amplitudes fall as 1/sqrt(mode), so that the sequence
  has tens of real principal components above the noise, as real
  sequences do; their intensity goes as (λmax/λ)², so that after the
  channels are aligned the spectral dimension holds three components
  (core, halo, speckles), as a real IFS sequence holds a few;
- white noise;
- one Gaussian companion that turns with the parallactic angle.

Every pattern is a function of the angular position, so at wavelength λ
the speckles, the halo and the star's core are the reference pattern
(at the longest wavelength) shrunk by λ/λmax: rescaling the channels by
λmax/λ aligns them. The small draws (wave vectors, phases, the companion)
come from numpy's generator and the bulk (the noise) from a
``torch.Generator`` on the device, all seeded from the seed, so a seed
gives the same sequence on the same kind of device. Nothing of the
program is used.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

_WAVES = 64       # cosines in one speckle pattern


@dataclass
class Sequence:
    cube: torch.Tensor       # (n, y, x) or (z, n, y, x), the config's dtype
    angles: np.ndarray       # (n,) parallactic angles, degrees, float64
    extras: dict             # further inputs: scale_list, fwhm


def parallactic_angles(cfg):
    """Linear field rotation over the sequence, each angle a float32
    value so that the program's float32 copy of it is exact."""
    a0, a1 = cfg["field_rotation_deg"]
    return np.linspace(a0, a1, cfg["frames"]).astype(np.float32) \
        .astype(np.float64)


def wavelengths(cfg):
    """(z,) wavelengths in micron, or None for a single-band sequence."""
    w = cfg.get("wavelengths_um")
    if w is None:
        return None
    return np.linspace(w["first"], w["last"], w["count"])


def _patterns(rng, n_pat, size, shrink, k_max, device):
    """(n_pat, len(shrink), size, size) float64 random fields of unit
    variance: each a sum of cosines with wave vectors up to ``k_max``
    cycles/px at the reference wavelength, evaluated at the coordinates
    (from the frame center size/2) multiplied by ``shrink`` (λmax/λ), as
    a separable product Y Xᵀ."""
    k = rng.uniform(0.15, 1.0, (n_pat, _WAVES)) * k_max
    th = rng.uniform(0, 2 * np.pi, (n_pat, _WAVES))
    ph = rng.uniform(0, 2 * np.pi, (n_pat, _WAVES))
    kx = torch.as_tensor(k * np.cos(th), device=device)[:, None, None, :]
    ky = torch.as_tensor(k * np.sin(th), device=device)[:, None, None, :]
    ph = torch.as_tensor(ph, device=device)[:, None, None, :]
    r = torch.arange(size, dtype=torch.float64, device=device) - size / 2
    s = torch.as_tensor(np.asarray(shrink, float), device=device)
    coord = s[None, :, None, None] * r[None, None, :, None]   # (1, z, S, 1)
    ay = 2 * math.pi * ky * coord + ph
    ax = 2 * math.pi * kx * coord
    Y = torch.cat((torch.cos(ay), -torch.sin(ay)), dim=-1)
    X = torch.cat((torch.cos(ax), torch.sin(ax)), dim=-1)
    return (Y @ X.mT) * math.sqrt(2.0 / _WAVES)


def _star(size, shrink, fwhm_ref, star, device):
    """(z, size, size) float64 core and (z, size, size) halo at each
    wavelength; the core's share grows as (λ/λmax)², as a Strehl ratio
    does."""
    r = torch.arange(size, dtype=torch.float64, device=device) - size / 2
    cores, halos = [], []
    for s in shrink:
        rr = torch.hypot(r[:, None] * s, r[None, :] * s)
        share = star["core_share"] / s ** 2
        cores.append(star["peak"] * share * torch.exp(
            -4 * math.log(2) * (rr / fwhm_ref) ** 2))
        halos.append(star["peak"] * (1 - share) * (
            1 + (rr / (star["halo_r0_fwhm"] * fwhm_ref)) ** 2)
            ** (-star["halo_beta"]))
    return torch.stack(cores), torch.stack(halos)


def _series(rng, modes, n, corr):
    """(n, modes) independent smooth random time series, each of zero
    mean and unit standard deviation over the n frames: white noise
    through a first-order recursive filter of ``corr`` frames, forward
    and back (no phase shift)."""
    a = np.exp(-1.0 / corr)
    x = rng.normal(size=(n, modes))
    for rows in (range(1, n), range(n - 2, -1, -1)):
        for t in rows:
            x[t] = a * x[t - 1 if rows.step == 1 else t + 1] + x[t]
    x -= x.mean(0)
    return x / x.std(0)


def make_sequence(cfg, seed, member, device):
    """Pool member ``member`` of the configuration ``cfg`` for ``seed``."""
    rng = np.random.default_rng([seed, member, 1])
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + member) % (1 << 63))
    n, S = cfg["frames"], cfg["frame_px"]
    lam = wavelengths(cfg)
    shrink = [1.0] if lam is None else list(lam.max() / lam)
    z = len(shrink)
    sp, star, comp = cfg["speckles"], cfg["star"], cfg["companion"]
    fwhm = cfg["fwhm_px"]                   # at the reference wavelength
    angles = parallactic_angles(cfg)

    pats = _patterns(rng, 1 + sp["modes"], S, shrink, 1.0 / fwhm, device)
    core, env = _star(S, shrink, fwhm, star, device)      # (z, S, S)
    amp = sp["breathing"] / np.sqrt(np.arange(1, sp["modes"] + 1))
    coef = np.concatenate((np.ones((n, 1)),
                           _series(rng, sp["modes"], n,
                                   sp["correlation_frames"]) * amp), 1)
    coef = torch.as_tensor(coef, device=device)            # (n, 1 + modes)
    pats[0] *= sp["static"]
    flux = 1.0 if lam is None else (lam / lam.max()) ** star["spectral_index"]
    flux = np.broadcast_to(np.asarray(flux, float), (z,))

    sep = rng.uniform(*comp["separation_fwhm"]) * fwhm
    pa0 = rng.uniform(0, 360)
    theta = np.deg2rad(pa0 + angles)
    cy = cx = S / 2
    yy = torch.as_tensor(cy + sep * np.sin(theta), device=device)
    xx = torch.as_tensor(cx + sep * np.cos(theta), device=device)
    grid = torch.arange(S, dtype=torch.float64, device=device)
    cflux = 1.0 if lam is None else (lam / lam.max()) ** \
        comp["spectral_index"]
    cflux = np.broadcast_to(np.asarray(cflux, float), (z,))

    dtype = getattr(torch, cfg.get("dtype", "float32"))
    cube = torch.empty((z, n, S, S), dtype=dtype, device=device)
    for c in range(z):
        e = env[c] * flux[c]
        # speckles are phase errors: their intensity goes as (λmax/λ)²
        base = (e * shrink[c] ** 2)[None] * pats[:, c]  # (1 + modes, S, S)
        base[0] += e + core[c] * flux[c]     # core + halo·(1 + c0·P0·g)
        ch = (coef @ base.reshape(base.shape[0], -1)).reshape(n, S, S)
        w = fwhm / shrink[c]
        gy = torch.exp(-4 * math.log(2) * ((grid[None] - yy[:, None]) / w)
                       ** 2)
        gx = torch.exp(-4 * math.log(2) * ((grid[None] - xx[:, None]) / w)
                       ** 2)
        ch += comp["peak"] * cflux[c] * gy[:, :, None] * gx[:, None, :]
        cube[c] = ch.to(dtype)
        del ch
    cube += cfg["noise_sigma"] * torch.randn(cube.shape, generator=gen,
                                             device=device, dtype=dtype)
    extras = {"fwhm": float(fwhm)}
    if lam is not None:
        extras["scale_list"] = lam.max() / lam
        extras["fwhm"] = float(np.mean(fwhm / np.asarray(shrink)))
        return Sequence(cube, angles, extras)
    return Sequence(cube[0], angles, extras)


def make_pool(cfg, seed, device):
    """The configuration's pool of sequences for ``seed``."""
    return [make_sequence(cfg, seed, m, device) for m in range(cfg["pool"])]

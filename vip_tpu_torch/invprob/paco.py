"""PACO: PAtch COvariance detection of companions ([FLA18]; port of
``vip_tpu.invprob.paco``).

The same classes (``PACO``, ``FastPACO``, ``FullPACO``) and statistics: a
shrinkage covariance of every pixel's patch column through the frames.
On the cube's device: the patches of every cell of the frame gathered at
once, their means and shrunk covariances, and one batched inverse of the
(cells, A, A) covariances, in chunks of cells under an 8 GiB working set;
the sub-pixel PSF bank of every (pixel, frame) position of the rotation
tracks (``ops.fft.fourier_shift_batch``); and the tracks' gathers of
inverse covariances, means and patches with the a/b contractions of
[FLA18] eqs. 15-16, in chunks of pixels under the same budget. The
tracks' geometry is host float64 numpy, as vip_tpu computes it.
FullPACO computes the statistics of the cells its tracks visit only.
Resampling the cube (``rescaling_factor`` other than 1) waits for
``preproc.rescaling`` (ROADMAP.md Queue 1, slice 7).
"""

import sys
from typing import Callable

import numpy as np
import torch

from ..config.device import as_tensor
from ..fm.fakecomp import _host, normalize_psf
from ..metrics.detection import detection
from ..ops.fft import fourier_shift_batch
from ..preproc.recentering import frame_shift
from ..var.coords import cart_to_pol, pol_to_cart

__all__ = ["FastPACO", "FullPACO"]

#: Working set of one chunk of the statistics or of the tracks (bytes): the
#: budget of ``preproc.derotation._auto_chunk``
_WORKING_SET = 8 << 30


class PACO:
    """Base PACO class (vip_tpu paco.py:29): the patch statistics and the
    ML flux and S/N along rotation tracks. The cube runs on its own device
    (numpy input on the default device)."""

    def __init__(self, cube, angles, psf, dit_psf=1.0, dit_science=1.0,
                 nd_transmission=1.0, fwhm=4.0, pixscale=1.0,
                 rescaling_factor=1.0, verbose=False):
        self.cube = as_tensor(cube)
        self.num_frames = self.cube.shape[0]
        self.width = self.cube.shape[2]
        self.height = self.cube.shape[1]
        self.angles = _host(angles)
        self.pixscale = pixscale
        self.rescaling_factor = rescaling_factor
        self.fwhm = int(fwhm / pixscale)

        psf = _host(psf)
        if psf.ndim > 2:
            psf = np.nanmedian(psf, axis=0)
        self.psf = psf * dit_science / dit_psf / nd_transmission
        self.dit_science = dit_science
        self.dit_psf = dit_psf

        mask = create_boolean_circular_mask(tuple(self.cube.shape[1:]),
                                            radius=self.fwhm)
        self.patch_area_pixels = int(mask.sum())
        self.patch_width = 2 * int(self.fwhm) + 3
        self.verbose = verbose
        self.snr = None
        self.flux = None
        self.std = None
        if self.verbose:
            print("---------------------- ")
            print("Summary of PACO setup: \n")
            print(f"Image Cube shape = {tuple(self.cube.shape)}")
            print(f"PIXSCALE = {self.pixscale:06}")
            print(f"Patch width: {self.patch_width}")
            print("---------------------- \n")
            sys.stdout.flush()

    def PACOCalc(self, phi0s, use_subpixel_psf_astrometry=True, cpu=1):
        """Algorithm-specific (a, b) of the pixels ``phi0s``."""
        raise NotImplementedError

    def run(self, cpu=1, imlib="vip-fft", interpolation="lanczos4",
            keep_center=True, use_subpixel_psf_astrometry=True):
        """Full PACO run (vip_tpu paco.py:73): (snr, flux) maps, tensors on
        the cube's device. As in vip_tpu, ``use_subpixel_psf_astrometry``
        is not forwarded: ``PACOCalc``'s default (True) applies."""
        if self.rescaling_factor != 1:
            self.rescale_cube_and_psf(imlib=imlib,
                                      interpolation=interpolation,
                                      keep_center=keep_center)
        x, y = np.meshgrid(np.arange(0, self.height),
                           np.arange(0, self.width))
        phi0s = np.column_stack((x.flatten(), y.flatten()))
        a, b = self.PACOCalc(np.array(phi0s), cpu=cpu)
        a = a.reshape(self.height, self.width)
        b = b.reshape(self.height, self.width)
        self.snr = b / torch.sqrt(a)
        self.flux = b / a
        self.std = 1 / torch.sqrt(a)
        return self.snr, self.flux

    def set_cube(self, cube):
        """Replace the science cube."""
        self.cube = as_tensor(cube)
        self.num_frames = self.cube.shape[0]
        self.width = self.cube.shape[2]
        self.height = self.cube.shape[1]

    def set_psf(self, psf):
        """Replace the PSF template."""
        self.psf = psf

    def set_angles(self, angles):
        """Replace the derotation angles."""
        self.angles = angles

    def get_patch(self, px, width=None, mask=None):
        """Column (n, A) of the circular patches at pixel ``px`` through the
        frames, NaN when the patch box leaves the frame (vip_tpu
        paco.py:113). A tensor on the cube's device."""
        if width is None:
            width = self.patch_width
        if mask is None:
            mask = create_boolean_circular_mask(tuple(self.cube.shape[1:]),
                                                radius=self.fwhm, center=px)
        k = int(width / 2)
        k2 = k + 1 if width % 2 != 0 else k
        nx, ny = self.cube.shape[1:3]
        if px[0] + k2 > nx or px[0] - k < 0 or px[1] + k2 > ny \
                or px[1] - k < 0:
            return torch.full((self.num_frames, self.patch_area_pixels),
                              torch.nan, dtype=self.cube.dtype,
                              device=self.cube.device)
        mask = torch.as_tensor(np.asarray(mask, bool),
                               device=self.cube.device)
        return self.cube[:, mask].reshape(self.num_frames, -1)

    def set_scale(self, scale):
        """Set the rescaling factor."""
        self.rescaling_factor = scale

    def rescale_cube_and_psf(self, imlib="vip-fft",
                             interpolation="lanczos4", keep_center=True):
        """Resample the cube and the PSF by the rescaling factor (vip_tpu
        paco.py:134). A factor of 1 does nothing; any other needs
        ``preproc.rescaling``, which is not ported yet."""
        if self.rescaling_factor == 1:
            if self.verbose:
                print("Scale is 1, no scaling applied.")
            return
        raise NotImplementedError(
            "PACO: rescaling_factor != 1 needs cube_px_resampling and "
            "frame_px_resampling (preproc.rescaling), not ported yet "
            "(ROADMAP.md Queue 1, slice 7)")

    def psf_model_function(self, mean, model: Callable, params: dict):
        """Deprecated analytic-PSF hook (vip_tpu paco.py:157)."""
        if self.psf is not None:
            return self.psf
        if model is None:
            raise ValueError("Please input either a 2D PSF or a model "
                             "function.")
        self.psf = model(mean, params)
        return self.psf

    def al(self, hfl, Cfl_inv, method=""):
        """a = Σ_l h_lᵀ C_l⁻¹ h_l, eq. 15 of [FLA18] (vip_tpu
        paco.py:167)."""
        hfl, Cfl_inv = _stack(hfl), _stack(Cfl_inv)
        return torch.einsum("lk,lkj,lj->", hfl, Cfl_inv.to(hfl), hfl)

    def bl(self, hfl, Cfl_inv, r_fl, m_fl, method=""):
        """b = Σ_l h_lᵀ C_l⁻¹ (r_l - m_l), eq. 16 of [FLA18] (vip_tpu
        paco.py:173)."""
        hfl, Cfl_inv = _stack(hfl), _stack(Cfl_inv)
        d = _stack(r_fl).to(hfl) - _stack(m_fl).to(hfl)
        return torch.einsum("lk,lkj,lj->", hfl, Cfl_inv.to(hfl), d)

    def _normalised_psf(self, full_output=False):
        """The PSF normalized with an Airy fit, as PACO's PSF model."""
        return normalize_psf(
            self.psf, fwhm="fit", size=None, threshold=None, mask_core=None,
            model="airy", imlib="vip-fft", interpolation="lanczos4",
            force_odd=False, full_output=full_output, verbose=self.verbose,
            debug=False)

    def flux_estimate(self, phi0s, eps=0.1, initial_est=[0.0]):
        """Unbiased iterative flux estimate at the positions ``phi0s``,
        algorithm 3 of [FLA18] (vip_tpu paco.py:180). Returns (estimates,
        their standard deviations, the PSF's normalization)."""
        print("Computing unbiased flux estimate...")
        if self.verbose:
            print("Initial guesses:")
            print("Positions: ", phi0s)
            print("Contrasts: ", initial_est)
        dim = self.width / 2
        normalised_psf, norm, _ = self._normalised_psf(full_output=True)
        psf_mask = create_boolean_circular_mask(normalised_psf.shape,
                                                radius=self.fwhm)
        dev, dt = self.cube.device, self.cube.dtype
        hoff = torch.zeros((self.num_frames, self.num_frames,
                            self.patch_area_pixels), dtype=dt, device=dev)
        x, y = np.meshgrid(np.arange(-dim, dim), np.arange(-dim, dim))
        mask_t = torch.as_tensor(psf_mask, device=dev)
        ests, stds = [], []
        for i, p0 in enumerate(phi0s):
            p0 = (p0[1], p0[0])
            angles_px = np.array(get_rotated_pixel_coords(x, y, p0,
                                                          self.angles))
            hon = []
            for ll, ang in enumerate(angles_px):
                offax = as_tensor(frame_shift(
                    normalised_psf, ang[1] - int(ang[1]),
                    ang[0] - int(ang[0]), imlib="vip-fft",
                    interpolation="lanczos4", border_mode="reflect"),
                    dev, dt)[mask_t]
                hoff[ll, ll] = offax
                hon.append(offax)
            Cinv, m, patches = self.compute_statistics(
                np.array(angles_px).astype(int))
            cells = [(int(ang[0]), int(ang[1])) for ang in angles_px]
            Cinlst = [Cinv[c] for c in cells]
            mlst = [m[c] for c in cells]
            patch = [patches[c][ll] for ll, c in enumerate(cells)]
            a = self.al(hon, Cinlst)
            b = self.bl(hon, Cinlst, patch, mlst)
            if self.verbose:
                print(float(b / a))

            ahat = initial_est[i]
            aprev = 1e10
            while np.abs(ahat - aprev) > np.abs(ahat * eps):
                m_it, Cinv_it = [], []
                for ll, ang in enumerate(angles_px):
                    apatch = self.get_patch(ang.astype(int))
                    mi, ci = self.iterate_flux_calc(ahat, apatch, hoff[ll])
                    m_it.append(mi)
                    Cinv_it.append(ci)
                a = self.al(hon, Cinv_it)
                b = self.bl(hon, Cinv_it, patch, m_it)
                aprev = ahat
                ahat = float(b / a)
                if self.verbose:
                    print(f"Flux estimate: {ahat / norm}")
            ests.append(np.abs(ahat / norm))
            stds.append(float(1 / torch.sqrt(a)) / norm)
        print("Extracted contrasts")
        print("-------------------")
        for i in range(len(phi0s)):
            print(f"x: {phi0s[i][0]}, y: {phi0s[i][1]}, flux: {ests[i]}"
                  f"±{stds[i]}")
        return ests, stds, norm

    def iterate_flux_calc(self, est, patch, model):
        """Mean and inverse covariance of the patch column with
        ``est`` x ``model`` removed from each frame (vip_tpu
        paco.py:249)."""
        if patch is None:
            return None, None
        return compute_statistics_at_pixel(as_tensor(patch) - est * model)

    def subpixel_threshold_detect(self, snr_map, threshold, mode="lpeaks",
                                  bkg_sigma=5.0, matched_filter=False,
                                  mask=True, full_output=False, cpu=1):
        """Sources of the S/N map above ``threshold``, by the port's
        ``metrics.detection`` (vip_tpu paco.py:258)."""
        peaks = detection(_host(snr_map), fwhm=self.fwhm,
                          psf=self.psf / np.nanmax(self.psf), mode=mode,
                          bkg_sigma=bkg_sigma, matched_filter=matched_filter,
                          mask=mask, snr_thresh=threshold, nproc=cpu,
                          plot=False, debug=False, full_output=full_output,
                          verbose=self.verbose)
        if full_output:
            return peaks.T
        return peaks

    def pixel_threshold_detection(self, snr_map, threshold):
        """(x, y) of the local maxima of the S/N map above ``threshold``
        (vip_tpu paco.py:273). Host numpy."""
        from scipy import ndimage
        from scipy.ndimage import maximum_filter

        snr_map = _host(snr_map)
        data_max = maximum_filter(snr_map, size=self.fwhm)
        maxima = snr_map == data_max
        maxima[(data_max > threshold) == 0] = 0
        labeled, _ = ndimage.label(maxima)
        x, y = [], []
        for dy, dx in ndimage.find_objects(labeled):
            x.append((dx.start + dx.stop - 1) / 2)
            y.append((dy.start + dy.stop - 1) / 2)
        return np.array(list(zip(x, y)))

    def _cell_statistics(self, cells):
        """Patch columns, means and inverse shrunk covariances of the dense
        layout's cells ``cells`` (flat indices f = r·W + c, which hold the
        patch of IMAGE pixel (row c, column r): vip_tpu's transposed
        storage, so that a track's cell is ``int(t0)·W + int(t1)``). Cells
        whose patch box leaves the frame are NaN. Returns tensors (n, m, A),
        (m, A), (m, A, A) on the cube's device."""
        n, H, W = self.cube.shape
        dev = self.cube.device
        k = int(self.patch_width / 2)
        k2 = k + 1 if self.patch_width % 2 != 0 else k
        tmpl = create_boolean_circular_mask((H, W), radius=self.fwhm,
                                            center=(H // 2, W // 2))
        oy, ox = np.nonzero(tmpl)
        oy, ox = oy - H // 2, ox - W // 2
        row_img = cells % W
        col_img = cells // W
        valid = ((row_img - k >= 0) & (row_img + k2 <= H)
                 & (col_img - k >= 0) & (col_img + k2 <= W))
        rc = np.clip(row_img, k, H - k2)
        cc = np.clip(col_img, k, W - k2)
        img_flat = torch.as_tensor(
            (rc[:, None] + oy[None, :]) * W + (cc[:, None] + ox[None, :]),
            device=dev)
        valid = torch.as_tensor(valid, device=dev)
        patches = self.cube.reshape(n, H * W)[:, img_flat]    # (n, m, A)
        patches = torch.where(valid[None, :, None], patches, torch.nan)
        m, Cinv = _batch_statistics_chunked(
            torch.nan_to_num(patches).transpose(0, 1))
        m = torch.where(valid[:, None], m, torch.nan)
        Cinv = torch.where(valid[:, None, None], Cinv, torch.nan)
        return patches, m, Cinv

    def _statistics_flat(self):
        """:meth:`_cell_statistics` of every cell of the frame: (patches
        (n, H·W, A), m (H·W, A), Cinv (H·W, A, A)) on the cube's device."""
        return self._cell_statistics(np.arange(self.height * self.width))

    def compute_statistics(self, phi0s):
        """Mean and inverse shrunk covariance of every cell's patch column
        (vip_tpu paco.py:343), in the dense layouts: (Cinv (H, W, A, A),
        m (H, W, A), patch (H, W, n, A)), tensors on the cube's device."""
        if self.verbose:
            print("Precomputing Statistics...")
        n, H, W = self.cube.shape
        A = self.patch_area_pixels
        patches, m, Cinv = self._statistics_flat()
        return (Cinv.reshape(H, W, A, A), m.reshape(H, W, A),
                patches.transpose(0, 1).reshape(H, W, n, A))

    def _tracks(self, phi0s):
        """Host float64 rotation tracks (npx, n, 2) of the pixels ``phi0s``
        (rows of (x, y)) and whether each stays in the frame, with the
        degree round trip of ``get_rotated_pixel_coords``."""
        dim = self.width / 2
        x, y = np.meshgrid(np.arange(-dim, dim), np.arange(-dim, dim))
        rows, cols = phi0s[:, 1].astype(int), phi0s[:, 0].astype(int)
        px_x, px_y = x[rows, cols], y[rows, cols]
        rad = np.sqrt(px_x ** 2 + px_y ** 2)
        theta_deg = np.rad2deg(np.arctan2(px_y, px_x))
        ang_r = np.deg2rad(-self.angles[None, :] + theta_deg[:, None])
        half = int(x.shape[0] / 2)
        tracks = np.stack([rad[:, None] * np.cos(ang_r) + half,
                           rad[:, None] * np.sin(ang_r) + half], axis=-1)
        flat = tracks.reshape(len(phi0s), -1)
        valid = (flat.max(1).astype(int) < self.width) \
            & (flat.min(1).astype(int) >= 0)
        return tracks, valid

    def _track_ab(self, phi0s, use_subpixel_psf_astrometry, statistics):
        """(a, b) of every pixel of ``phi0s``: NaN where its track leaves
        the frame; else the contraction over the track's cells of
        ``statistics(cells) -> (patches, m, Cinv, row of each cell)`` with
        the PSF bank (or the centred PSF)."""
        npx = len(phi0s)
        dev, dt = self.cube.device, self.cube.dtype
        tracks, valid = self._tracks(phi0s)
        vidx = np.nonzero(valid)[0]
        a = torch.full((npx,), torch.nan, dtype=dt, device=dev)
        b = torch.full_like(a, torch.nan)
        if not len(vidx):
            return a, b
        normalised_psf = self._normalised_psf()
        psf_mask = create_boolean_circular_mask(normalised_psf.shape,
                                                radius=self.fwhm)
        psf_t = as_tensor(normalised_psf, dev, dt)
        if use_subpixel_psf_astrometry:
            bank = _subpixel_psf_bank(psf_t, tracks[vidx], psf_mask)
        else:
            bank = psf_t[torch.as_tensor(psf_mask, device=dev)].expand(
                len(vidx), self.num_frames, -1)
        cells = (tracks[vidx, :, 0].astype(np.int64) * self.width
                 + tracks[vidx, :, 1].astype(np.int64))         # (nv, n)
        patches, m, Cinv, row = statistics(cells)
        A = m.shape[-1]
        n = self.num_frames
        frames = torch.arange(n, device=dev)[None, :]
        step = int(max(1, _WORKING_SET // (3 * n * A * (A + 3) * 8)))
        av, bv = [], []
        for lo in range(0, len(vidx), step):
            ft = torch.as_tensor(row(cells[lo:lo + step]), device=dev)
            h = bank[lo:lo + step]
            d = patches[frames, ft] - m[ft]                      # (c, n, A)
            C = Cinv[ft]                                         # (c,n,A,A)
            av.append((h * (C @ h[..., None])[..., 0]).sum((1, 2)))
            bv.append((h * (C @ d[..., None])[..., 0]).sum((1, 2)))
        vt = torch.as_tensor(vidx, device=dev)
        a[vt] = torch.cat(av)
        b[vt] = torch.cat(bv)
        return a, b


def _stack(x):
    """A tensor of a tensor, an array or a list of tensors or arrays."""
    if isinstance(x, torch.Tensor):
        return x
    if len(x) and isinstance(x[0], torch.Tensor):
        return torch.stack(list(x))
    return as_tensor(np.asarray(x))


def _subpixel_psf_bank(psf, angs, mask, chunk=8192):
    """The PSF shifted by the sub-pixel part of every (pixel, frame)
    position of the tracks ``angs`` (nv, nf, 2), restricted to ``mask``:
    (nv, nf, A) on the PSF's device (vip_tpu paco.py:361). Chunks of
    ``chunk`` batched 'vip-fft' shifts with the pad margin 1 (an
    exact-zero shift is the identity either way)."""
    psf = as_tensor(psf)
    nv, nf, _ = angs.shape
    sy = (angs[..., 1] - angs[..., 1].astype(int)).ravel()
    sx = (angs[..., 0] - angs[..., 0].astype(int)).ravel()
    mask = torch.as_tensor(np.asarray(mask, bool), device=psf.device)
    pieces = []
    for k0 in range(0, sy.shape[0], chunk):
        n_k = min(chunk, sy.shape[0] - k0)
        block = fourier_shift_batch(psf.expand(n_k, *psf.shape),
                                    sy[k0:k0 + n_k], sx[k0:k0 + n_k], 1)
        pieces.append(block[:, mask])
    return torch.cat(pieces).reshape(nv, nf, -1)


class FastPACO(PACO):
    """Algorithm 2 of [FLA18] (vip_tpu paco.py:393): the statistics of
    every cell once, then every rotation track."""

    def PACOCalc(self, phi0s, use_subpixel_psf_astrometry=True, cpu=1):
        """(a, b) of the pixels ``phi0s`` (rows of (x, y)), tensors on the
        cube's device (vip_tpu paco.py:397): the statistics of the whole
        frame, the PSF bank of the tracks and their contractions, all on
        the device."""
        if self.verbose:
            print("Running Fast PACO...")
        patches, m, Cinv = self._statistics_flat()
        a, b = self._track_ab(
            np.asarray(phi0s), use_subpixel_psf_astrometry,
            lambda cells: (patches, m, Cinv, lambda c: c))
        if self.verbose:
            print("Done")
        return a, b

    def compute_statistics_parallel(self, phi0s, cpu):
        """API parity: the statistics are batched on the device."""
        return self.compute_statistics(phi0s)


class FullPACO(PACO):
    """Algorithm 1 of [FLA18] (vip_tpu paco.py:499): the statistics of the
    cells the tracks visit only."""

    def PACOCalc(self, phi0s, use_subpixel_psf_astrometry=True, cpu=1):
        """(a, b) of the pixels ``phi0s`` (rows of (x, y)), tensors on the
        cube's device (vip_tpu paco.py:503)."""
        if self.verbose:
            print("Running Full PACO...")
        if cpu > 1:
            print("Multiprocessing for full PACO is not yet implemented!")

        def visited(cells):
            uniq = np.unique(cells)
            patches, m, Cinv = self._cell_statistics(uniq)
            return patches, m, Cinv, lambda c: np.searchsorted(uniq, c)

        a, b = self._track_ab(np.asarray(phi0s), use_subpixel_psf_astrometry,
                              visited)
        if self.verbose:
            print("Done")
        return a, b


def _batch_statistics(patches):
    """Means (P, A) and inverse shrunk covariances (P, A, A) of P patch
    columns (P, T, A) (vip_tpu paco.py:583-610): S = Σ_l (p_l - m)(p_l -
    m)ᵀ / (2T), shrunk towards its diagonal by ρ, inverted in one batched
    LU inverse."""
    T = patches.shape[1]
    m = patches.mean(1)
    d = patches - m[:, None, :]
    S = d.transpose(1, 2) @ d / (2 * T)
    diag_S = torch.diagonal(S, dim1=1, dim2=2)
    trS2 = (S * S.transpose(1, 2)).sum((1, 2))
    top = trS2 + diag_S.sum(1) ** 2 - 2.0 * (S ** 2).sum((1, 2))
    bot = (T + 1.0) * (trS2 - (diag_S ** 2).sum(1))
    rho = (top / bot).clamp(0.0, 1.0)[:, None, None]
    C = (1.0 - rho) * S + rho * torch.diag_embed(diag_S)
    return m, torch.linalg.inv(C)


def _batch_statistics_chunked(patches, chunk=None):
    """:func:`_batch_statistics` in chunks of patch columns, by default as
    many as fit the 8 GiB working set."""
    P, T, A = patches.shape
    if chunk is None:
        chunk = int(max(1, _WORKING_SET // ((T * A + 4 * A * A) * 8)))
    if P <= chunk:
        return _batch_statistics(patches)
    m = patches.new_empty((P, A))
    Cinv = patches.new_empty((P, A, A))
    for lo in range(0, P, chunk):
        m[lo:lo + chunk], Cinv[lo:lo + chunk] = _batch_statistics(
            patches[lo:lo + chunk])
    return m, Cinv


def compute_statistics_at_pixel(patch):
    """Mean and inverse shrunk covariance of one patch column (T, A)
    (vip_tpu paco.py:638). Tensors on the patch's device."""
    if patch is None:
        return None, None
    patch = as_tensor(patch)
    T = patch.shape[0]
    m = patch.mean(0)
    S = sample_covariance(patch, m, T)
    rho = shrinkage_factor(S, T)
    F = diagsample_covariance(S)
    C = covariance(rho, S, F)
    return m, torch.linalg.inv(C)


def covariance(rho, S, F):
    """Shrinkage covariance (1 - ρ) S + ρ F (vip_tpu paco.py:653)."""
    return (1.0 - rho) * S + rho * F


def sample_covariance(r, m, T):
    """Sample covariance Σ_l (r_l - m)(r_l - m)ᵀ / (2T) of a patch column
    (vip_tpu paco.py:658)."""
    d = as_tensor(r) - as_tensor(m)
    return torch.einsum("lk,lj->kj", d, d) / (2.0 * T)


def diagsample_covariance(S):
    """The diagonal of the sample covariance (vip_tpu paco.py:666)."""
    return torch.diag(torch.diagonal(as_tensor(S)))


def shrinkage_factor(S, T):
    """Shrinkage weight ρ in [0, 1] (vip_tpu paco.py:671), a 0-d tensor."""
    S = as_tensor(S)
    trS2 = torch.trace(S @ S)
    top = trS2 + torch.trace(S) ** 2 - 2.0 * (S ** 2.0).sum()
    bot = (T + 1.0) * (trS2 - (torch.diagonal(S) ** 2.0).sum())
    return (top / bot).clamp(0.0, 1.0)


def get_rotated_pixel_coords(x, y, p0, angles, astro_convention=False):
    """Track (n, 2) of pixel ``p0`` of the grids (x, y) through the
    rotations ``angles`` (vip_tpu paco.py:679). Host numpy."""
    phi0 = np.array([x[int(p0[0]), int(p0[1])], y[int(p0[0]), int(p0[1])]])
    rad, theta = cart_to_pol(phi0[0], phi0[1],
                             astro_convention=astro_convention)
    angles_rad = -1 * np.asarray(angles) + theta
    nx, ny = pol_to_cart(rad * np.ones_like(angles_rad), angles_rad,
                         astro_convention=astro_convention)
    nx = nx + int(x.shape[0] / 2)
    ny = ny + int(x.shape[0] / 2)
    return np.array([nx, ny]).T


def create_boolean_circular_mask(shape, radius=4, center=None):
    """Boolean disk of ``radius`` about ``center`` (the frame's centre by
    default) in a frame of ``shape`` (vip_tpu paco.py:692). Host numpy."""
    w = shape[0]
    h = shape[1]
    if center is None:
        center = [int(w / 2), int(h / 2)]
    if radius is None:
        radius = min(center[0], center[1], w - center[0], h - center[1])
    X, Y = np.ogrid[:w, :h]
    dist2 = (X - center[0]) ** 2 + (Y - center[1]) ** 2
    return dist2 <= radius ** 2

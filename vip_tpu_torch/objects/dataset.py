"""High-contrast dataset objects: Frame and Dataset (port of
``vip_tpu.objects.dataset``, VIP's objects/dataset.py).

A ``Dataset`` holds its cube, reference cube and PSFs as tensors: numpy
input goes to the device of :func:`vip_tpu_torch.set_device` once, at
construction (a tensor stays on its own device), so each run of a
post-processing object reuses the cube where it lives. The angles and
wavelengths stay host numpy, as the reductions take them. The methods
call the port's functions of the same names; ``plot`` imports matplotlib
and draws host copies.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..config.utils_conf import Saveable, check_array, print_precision
from ..fits import open_fits
from ..fm.fakecomp import (cube_inject_companions,
                           generate_cube_copies_with_injections,
                           normalize_psf)
from ..metrics.detection import detection
from ..metrics.snr_source import frame_report, snr
from ..preproc.badframes import (cube_detect_badfr_correlation,
                                 cube_detect_badfr_ellipticity,
                                 cube_detect_badfr_pxstats)
from ..preproc.cosmetics import cube_crop_frames, cube_drop_frames, frame_crop
from ..preproc.derotation import cube_derotate, frame_rotate
from ..preproc.recentering import (cube_recenter_2dfit,
                                   cube_recenter_dft_upsampling,
                                   cube_recenter_radon,
                                   cube_recenter_satspots,
                                   cube_recenter_via_speckles,
                                   frame_center_satspots, frame_shift)
from ..preproc.rescaling import cube_px_resampling, frame_px_resampling
from ..preproc.subsampling import cube_collapse, cube_subsample
from ..stats.distances import cube_distance
from ..stats.im_stats import frame_average_radprofile
from ..stats.utils_stats import cube_basic_stats, frame_basic_stats
from ..var.coords import frame_center
from ..var.filters import (cube_filter_highpass, cube_filter_lowpass,
                           frame_filter_highpass, frame_filter_lowpass)
from ..var.shapes import mask_circle

__all__ = ["Dataset", "Frame"]


def _on_device(x, hdu=0):
    """A FITS path, an array or a tensor as a tensor: a path is read, an
    array goes to the default device, a tensor stays where it is."""
    if isinstance(x, str):
        x = open_fits(x, hdu, verbose=False)
    return x if isinstance(x, torch.Tensor) else as_tensor(x)


def _host_vector(x, hdu=0):
    """A FITS path, a list, an array or a tensor as a host numpy array."""
    if isinstance(x, str):
        return open_fits(x, hdu, verbose=False)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _nbytes(x):
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return getattr(x, "nbytes", 0)


class Frame:
    """2-d image with the frame methods of VIP's Frame (vip_tpu
    dataset.py:38). ``data`` is a FITS path, an array or a tensor, and
    stays as given (a path is read as host numpy)."""

    def __init__(self, data, hdu=0, fwhm=None):
        if isinstance(data, str):
            self.data = open_fits(data, hdu, verbose=False)
        else:
            self.data = data
        check_array(self.data, dim=2, msg="Image.data")
        print("Frame shape: {}".format(tuple(self.data.shape)))
        self.fwhm = fwhm
        if self.fwhm is not None:
            print("FWHM: {}".format(self.fwhm))

    def crop(self, size, xy=None, force=False):
        """Crop the frame (vip_tpu dataset.py:53)."""
        self.data = frame_crop(self.data, size, xy, force, verbose=True)

    def detect_blobs(self, psf, bkg_sigma=1, method="lpeaks",
                     matched_filter=False, mask=True, snr_thresh=5,
                     plot=True, debug=False, verbose=False,
                     save_plot=None, plot_title=None, angscale=False, *,
                     full_output=True):
        """Detect point-like sources (vip_tpu dataset.py:57) into
        ``detection_results``: a pandas table, as in vip_tpu, or with
        ``full_output=False`` the host (yy, xx) arrays, which need no
        pandas."""
        self.detection_results = detection(
            self.data, psf=psf, bkg_sigma=bkg_sigma, mode=method,
            matched_filter=matched_filter, mask=mask,
            snr_thresh=snr_thresh, plot=plot, debug=debug,
            full_output=full_output, verbose=verbose, save_plot=save_plot,
            plot_title=plot_title)

    def filter(self, method, mode, median_size=5, kernel_size=5,
               fwhm_size=5, btw_cutoff=0.2, btw_order=2, hann_cutoff=5,
               gauss_mode="conv"):
        """Low/high-pass filter the frame (vip_tpu dataset.py:69)."""
        if method == "hp":
            self.data = frame_filter_highpass(
                self.data, mode, median_size, kernel_size, fwhm_size,
                btw_cutoff, btw_order, hann_cutoff, conv_mode=gauss_mode)
        elif method == "lp":
            self.data = frame_filter_lowpass(self.data, mode, median_size,
                                             fwhm_size, gauss_mode)
        else:
            raise ValueError("Filtering mode not recognized")
        print("Image successfully filtered")

    def get_center(self, verbose=True):
        """Frame center coordinates (vip_tpu dataset.py:84)."""
        return frame_center(self.data, verbose)

    def plot(self, **kwargs):
        """Plot a host copy of the frame with matplotlib."""
        import matplotlib.pyplot as plt
        plt.figure()
        plt.imshow(_host(self.data), origin="lower", **kwargs)
        plt.colorbar()
        plt.show()

    def radial_profile(self, sep=1):
        """Average radial profile (vip_tpu dataset.py:96)."""
        return frame_average_radprofile(self.data, sep=sep, plot=False)

    def recenter(self, method="satspots", xy=None, subi_size=19,
                 sigfactor=6, imlib="vip-fft", interpolation="lanczos4",
                 debug=False, verbose=True):
        """Recenter the frame (vip_tpu dataset.py:100)."""
        if method == "satspots":
            if xy is None:
                raise ValueError("`xy` must be a tuple of 4 tuples")
            self.data, _, _, _, _ = frame_center_satspots(
                self.data, xy, subi_size, sigfactor, True, "moff", (0, 0),
                "reflect", imlib, interpolation, debug, verbose)
        elif method == "radon":
            pass
        else:
            raise ValueError("Recentering method not recognized")

    def rescale(self, scale, imlib="vip-fft", interpolation="bicubic",
                verbose=True):
        """Resample the frame (vip_tpu dataset.py:115)."""
        self.data = frame_px_resampling(self.data, scale, imlib,
                                        interpolation, verbose=verbose)

    def rotate(self, angle, imlib="vip-fft", interpolation="lanczos4",
               cxy=None):
        """Rotate the frame (vip_tpu dataset.py:121)."""
        self.data = frame_rotate(self.data, angle, imlib, interpolation,
                                 cxy)
        print("Image successfully rotated")

    def shift(self, shift_y, shift_x, imlib="vip-fft",
              interpolation="lanczos4"):
        """Shift the frame (vip_tpu dataset.py:128)."""
        self.data = frame_shift(self.data, shift_y, shift_x, imlib,
                                interpolation)
        print("Image successfully shifted")

    def snr(self, source_xy, plot=False, verbose=True):
        """S/N at a position (vip_tpu dataset.py:135)."""
        if self.fwhm is None:
            raise ValueError("FWHM has not been set")
        return snr(self.data, source_xy, self.fwhm, False, plot=plot,
                   verbose=verbose)

    def stats(self, region="circle", radius=5, xy=None, annulus_inner_radius=0,
              annulus_width=5, source_xy=None, verbose=True, plot=True):
        """Region statistics and frame report (vip_tpu dataset.py:142)."""
        res_region = frame_basic_stats(self.data, region, radius, xy,
                                       annulus_inner_radius, annulus_width,
                                       plot=plot, full_output=True)
        if verbose:
            if region == "circle":
                msg = "Stats in circular aperture of radius: {}pxs"
                print(msg.format(radius))
            elif region == "annulus":
                msg = "Stats in annulus. Inner_rad: {}pxs, width: {}pxs"
                print(msg.format(annulus_inner_radius, annulus_width))
            mean_, std_dev, median, maxi = res_region
            msg = "Mean: {:.3f}, Stddev: {:.3f}, Median: {:.3f}, Max: {:.3f}"
            print(msg.format(mean_, std_dev, median, maxi))
        if source_xy is not None and self.fwhm is not None:
            print("Frame S/N info:")
            _ = frame_report(self.data, self.fwhm, source_xy,
                             verbose=verbose)
        return res_region


class Dataset(Saveable):
    """High-contrast imaging dataset: cube, angles, PSF and wavelengths
    (vip_tpu dataset.py:165). ``cube``, ``cuberef``, ``psf`` and ``psfn``
    are tensors on the device (see the module's docstring); ``save``
    writes them as host arrays in vip_tpu's layout and ``load`` puts them
    back on the device."""

    _saved_attributes = ["cube", "psf", "psfn", "angles", "fwhm",
                         "wavelengths", "px_scale", "cuberef",
                         "injections_yx"]
    _tensor_attributes = ("cube", "psf", "psfn", "cuberef")

    def _set_shape_attrs(self):
        """Derive (w, n, y, x) from the cube shape."""
        if self.cube.ndim == 3:
            self.n, self.y, self.x = self.cube.shape
            self.w = 1
        else:
            self.w, self.n, self.y, self.x = self.cube.shape

    def _post_load(self):
        """Recompute shape-derived attributes after ``Saveable.load``
        (which restores only ``_saved_attributes``)."""
        if isinstance(self.cube, (np.ndarray, torch.Tensor)):
            self._set_shape_attrs()

    def _keep_placed(self, array):
        """``array`` (a host result) on the cube's device, in its dtype."""
        return as_tensor(array, device=self.cube.device,
                         dtype=self.cube.dtype)

    def __init__(self, cube, hdu=0, angles=None, wavelengths=None,
                 fwhm=None, px_scale=None, psf=None, psfn=None,
                 cuberef=None):
        if isinstance(cube, str):
            self.cube = _on_device(cube, hdu)
        elif isinstance(cube, (np.ndarray, torch.Tensor)):
            if not (cube.ndim == 3 or cube.ndim == 4):
                raise ValueError("`Cube` array has wrong dimensions")
            self.cube = _on_device(cube)
        else:
            raise TypeError("`Cube` has a wrong type")

        self._set_shape_attrs()

        if isinstance(cuberef, str):
            self.cuberef = _on_device(cuberef, hdu)
        elif isinstance(cuberef, (np.ndarray, torch.Tensor)):
            if cuberef.ndim != self.cube.ndim or \
                    cuberef.shape[-1] != self.cube.shape[-1]:
                raise ValueError("`Cuberef` array has wrong dimensions")
            self.cuberef = _on_device(cuberef)
        elif isinstance(cuberef, Dataset):
            self.cuberef = cuberef.cube
        else:
            self.cuberef = None

        if angles is not None:
            self.angles = _host_vector(angles)
            check_array(self.angles, dim=1,
                        msg="Parallactic angles vector")
            if self.angles.shape[0] != self.n:
                raise ValueError("Parallactic angles vector has a wrong "
                                 "shape")
        else:
            self.angles = angles

        if wavelengths is not None:
            self.wavelengths = _host_vector(wavelengths)
            check_array(self.wavelengths, dim=1, msg="Wavelengths vector")
        else:
            self.wavelengths = wavelengths

        self.psf = None if psf is None else _on_device(psf, hdu)
        self.psfn = None if psfn is None else _on_device(psfn)
        self.fwhm = fwhm
        self.px_scale = px_scale
        self.injections_yx = None

    def collapse(self, mode="median", n=50):
        """Collapse the cube into a Frame (vip_tpu dataset.py:247)."""
        frame = cube_collapse(self.cube, mode, n)
        print("Cube successfully collapsed")
        return Frame(frame, fwhm=self.fwhm)

    def crop_frames(self, size, xy=None, force=False):
        """Crop every frame of the cube (vip_tpu dataset.py:253)."""
        self.cube = cube_crop_frames(self.cube, size, xy, force,
                                     verbose=True)
        if self.cube.ndim == 3:
            self.n, self.y, self.x = self.cube.shape
        else:
            self.w, self.n, self.y, self.x = self.cube.shape

    def derotate(self, imlib="vip-fft", interpolation="lanczos4", cxy=None,
                 nproc=1, border_mode="constant", mask_val=np.nan,
                 edge_blend=None, interp_zeros=False, ker=1):
        """Derotate the cube with the stored angles (vip_tpu
        dataset.py:262)."""
        if self.angles is None:
            raise ValueError("Parallactic angles vector has not been set")
        self.cube = cube_derotate(self.cube, self.angles, imlib,
                                  interpolation, cxy, nproc, border_mode,
                                  mask_val, edge_blend, interp_zeros, ker)
        print("Cube successfully derotated")

    def drop_frames(self, n, m, verbose=True):
        """Keep only frames n..m (vip_tpu dataset.py:274)."""
        res = cube_drop_frames(self.cube, n, m, self.angles,
                               verbose=verbose)
        self.cube, self.angles = res
        if self.cube.ndim == 3:
            self.n = self.cube.shape[0]

    def filter(self, method, mode, median_size=5, kernel_size=5,
               fwhm_size=5, btw_cutoff=0.2, btw_order=2, hann_cutoff=5,
               gauss_mode="conv", verbose=True):
        """Filter every frame of the cube (vip_tpu dataset.py:282)."""
        if method == "hp":
            self.cube = cube_filter_highpass(
                self.cube, mode, verbose=verbose, median_size=median_size,
                kernel_size=kernel_size, fwhm_size=fwhm_size,
                btw_cutoff=btw_cutoff, btw_order=btw_order,
                hann_cutoff=hann_cutoff, conv_mode=gauss_mode)
        elif method == "lp":
            self.cube = cube_filter_lowpass(self.cube, mode,
                                            median_size=median_size,
                                            fwhm_size=fwhm_size,
                                            conv_mode=gauss_mode,
                                            verbose=verbose)
        else:
            raise ValueError("Filtering method not recognized")

    def frame_distances(self, frame, region="full", dist="sad",
                        inner_radius=None, width=None, plot=True):
        """Distances of each frame to a reference frame (vip_tpu
        dataset.py:301)."""
        return cube_distance(self.cube, frame, region, dist, inner_radius,
                             width, plot=plot)

    def frame_stats(self, region="circle", radius=5, xy=None,
                    annulus_inner_radius=0, annulus_width=5, wavelength=0,
                    plot=True):
        """Per-frame statistics in a region (vip_tpu dataset.py:308)."""
        if self.cube.ndim == 3:
            cube = self.cube
        else:
            cube = self.cube[wavelength]
        return cube_basic_stats(cube, region, radius, xy,
                                annulus_inner_radius, annulus_width,
                                plot=plot, full_output=True)

    def inject_companions(self, flux, rad_dists, n_branches=1, theta=0,
                          imlib="vip-fft", interpolation="lanczos4",
                          full_output=False, verbose=True):
        """Inject fake companions into the cube (vip_tpu dataset.py:321).
        The injection is the port's host ``cube_inject_companions``; the
        cube goes back to its device and dtype."""
        if self.angles is None:
            raise ValueError("The PA angles have not been set")
        if self.psfn is None:
            raise ValueError("The normalized PSF array cannot be found")
        if self.px_scale is None:
            raise ValueError("Pixel/plate scale has not been set")
        if self.cube.ndim == 4 and self.wavelengths is None:
            raise ValueError("The wavelengths vector has not been set")

        cube, yx = cube_inject_companions(
            self.cube, self.psfn, self.angles, flux, rad_dists,
            self.px_scale, n_branches, theta, imlib, interpolation,
            full_output=True, verbose=verbose)
        self.cube = self._keep_placed(cube)
        if self.injections_yx is None:
            self.injections_yx = []
        self.injections_yx += yx
        if verbose:
            print("Coordinates of the injections stored in "
                  "self.injections_yx")
        if full_output:
            return yx

    def generate_copies_with_injections(self, n_copies, inrad=8, outrad=12,
                                        dist_flux=("uniform", 2, 500)):
        """Yield dataset copies with random injections (vip_tpu
        dataset.py:348), each cube on this cube's device."""
        for data in generate_cube_copies_with_injections(
                self.cube, self.psf, self.angles, self.px_scale,
                n_copies=n_copies, inrad=inrad, outrad=outrad,
                dist_flux=dist_flux):
            dsi = self.copy()
            dsi.cube = self._keep_placed(data["cube"])
            dsi.injections_yx = data["positions"]
            yield dsi

    def get_nbytes(self):
        """Total bytes of the stored arrays and tensors (vip_tpu
        dataset.py:361)."""
        return sum(_nbytes(arr) for arr in
                   [self.cube, self.cuberef, self.angles, self.wavelengths,
                    self.psf, self.psfn] if arr is not None)

    def copy(self, deep=True, check_mem=True):
        """Copy the Dataset (vip_tpu dataset.py:369). ``check_mem`` checks
        1.5x the dataset's bytes against the free memory where the cube
        lives: the card's (``config.mem.get_available_hbm``) or the
        host's."""
        import copy as copy_mod
        if deep:
            if check_mem:
                from ..config.mem import get_available_hbm

                need = 1.5 * self.get_nbytes()
                if need > get_available_hbm(self.cube.device):
                    raise RuntimeError("copy would require more memory "
                                       "than available.")
            return copy_mod.deepcopy(self)
        return copy_mod.copy(self)

    def load_angles(self, angles, hdu=0):
        """Load the parallactic angles (vip_tpu dataset.py:383)."""
        if isinstance(angles, (str, list, np.ndarray, torch.Tensor)):
            self.angles = _host_vector(angles, hdu)
        else:
            raise ValueError("Angles format not recognized")

    def load_wavelengths(self, wavelengths, hdu=0):
        """Load the wavelengths vector (vip_tpu dataset.py:392)."""
        if isinstance(wavelengths, (str, list, np.ndarray, torch.Tensor)):
            self.wavelengths = _host_vector(wavelengths, hdu)
        else:
            raise ValueError("Wavelengths format not recognized")

    def mask_center(self, radius, fillwith=0, mode="in"):
        """Mask the center of every frame (vip_tpu dataset.py:401)."""
        self.cube = mask_circle(self.cube, radius, fillwith, mode)

    def normalize_psf(self, fit_fwhm=True, size=None, threshold=None,
                      mask_core=None, model="gauss", imlib="vip-fft",
                      interpolation="lanczos4", force_odd=True,
                      verbose=True):
        """Normalize the PSF template; sets psfn (on the PSF's device)
        and fwhm (vip_tpu dataset.py:406)."""
        if self.psf is None:
            raise ValueError("PSF array has not been loaded")
        if fit_fwhm is True:
            fwhm = "fit"
        elif fit_fwhm:
            fwhm = fit_fwhm
        elif self.fwhm:
            fwhm = self.fwhm
        else:
            fwhm = "fit"
        psfn, self.aperture_flux, self.fwhm = normalize_psf(
            self.psf, fwhm, size, threshold, mask_core, model, imlib,
            interpolation, force_odd, full_output=True, verbose=verbose)
        self.psfn = as_tensor(psfn, device=self.psf.device,
                              dtype=self.psf.dtype)
        print("Normalized PSF array shape: {}".format(
            tuple(self.psfn.shape)))
        print("The attribute `psfn` contains the normalized PSF")
        print("`fwhm` attribute set to")
        print_precision(self.fwhm)

    def plot(self, **kwargs):
        """Plot host copies of the cube's frames with matplotlib."""
        import matplotlib.pyplot as plt
        cube = _host(self.cube if self.cube.ndim == 3 else self.cube[0])
        ncols = min(4, cube.shape[0])
        nrows = int(np.ceil(cube.shape[0] / ncols))
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(3 * ncols, 3 * nrows))
        for i, ax in enumerate(np.atleast_1d(axes).ravel()):
            if i < cube.shape[0]:
                ax.imshow(cube[i], origin="lower", **kwargs)
            ax.axis("off")
        plt.show()

    def recenter(self, method="2dfit", xy=None, subi_size=5, model="gauss",
                 nproc=1, imlib="vip-fft", interpolation="lanczos4",
                 offset=None, negative=False, threshold=False,
                 save_shifts=False, cy_1=None, cx_1=None,
                 upsample_factor=100, alignment_iter=5, gamma=1,
                 min_spat_freq=0.5, max_spat_freq=3, recenter_median=False,
                 sigfactor=6, cropsize=101, hsize=0.4, step=0.01,
                 mask_center=None, verbose=True, debug=False, plot=True):
        """Recenter the cube in place (vip_tpu dataset.py:445)."""
        if method == "2dfit":
            if self.fwhm is None:
                raise ValueError("FWHM has not been set")
            self.cube = cube_recenter_2dfit(
                self.cube, xy, self.fwhm, subi_size, model, nproc, imlib,
                interpolation, offset, negative, threshold,
                save_shifts=save_shifts, full_output=False,
                verbose=verbose, debug=debug, plot=plot)
        elif method == "dftups":
            if self.fwhm is None:
                raise ValueError("FWHM has not been set")
            center_fr1 = (cy_1, cx_1) if cy_1 is not None else None
            self.cube = cube_recenter_dft_upsampling(
                self.cube, center_fr1=center_fr1, negative=negative,
                fwhm=self.fwhm, subi_size=subi_size,
                upsample_factor=upsample_factor, imlib=imlib,
                interpolation=interpolation, full_output=False,
                verbose=verbose, save_shifts=save_shifts, debug=debug,
                plot=plot)
        elif method == "dftupspeckles":
            if self.fwhm is None:
                raise ValueError("FWHM has not been set")
            res = cube_recenter_via_speckles(
                self.cube, self.cuberef, alignment_iter, gamma,
                min_spat_freq, max_spat_freq, self.fwhm, upsample_factor,
                debug, recenter_median, "gaus", negative, True, subi_size,
                imlib=imlib, interpolation=interpolation, plot=plot)
            self.cube = res[0]
            if self.cuberef is not None:
                self.cuberef = res[1]
        elif method == "satspots":
            self.cube, _, _, _, _ = cube_recenter_satspots(
                self.cube, xy, subi_size, sigfactor, plot, debug=debug,
                verbose=verbose, full_output=True)
        elif method == "radon":
            self.cube = cube_recenter_radon(
                self.cube, full_output=False, verbose=verbose, imlib=imlib,
                interpolation=interpolation, cropsize=cropsize,
                hsize_ini=hsize, step_ini=step, mask_center=mask_center,
                nproc=nproc, debug=debug)
        else:
            raise ValueError("Method not recognized")

    def remove_badframes(self, method="corr", frame_ref=None, crop_size=30,
                         dist="pearson", percentile=20,
                         stat_region="annulus", inner_radius=10, width=10,
                         top_sigma=1.0, low_sigma=1.0, window=None,
                         roundlo=-0.2, roundhi=0.2, lambda_ref=0,
                         plot=True, verbose=True):
        """Identify and remove bad frames (vip_tpu dataset.py:499)."""
        if self.cube.ndim == 4:
            cube = self.cube[lambda_ref]
        else:
            cube = self.cube

        if method == "corr":
            if frame_ref is None:
                print("Correlation method selected but `frame_ref` is "
                      "missing")
                print("Setting the 1st frame as the reference")
                frame_ref = 0
            good, _ = cube_detect_badfr_correlation(
                cube, frame_ref, crop_size, dist, percentile, plot=plot,
                verbose=verbose)
        elif method == "pxstats":
            good, _ = cube_detect_badfr_pxstats(
                cube, stat_region, inner_radius, width, top_sigma,
                low_sigma, window, plot=plot, verbose=verbose)
        elif method == "ellip":
            if self.fwhm is None:
                raise ValueError("FWHM has not been set")
            good, _ = cube_detect_badfr_ellipticity(
                cube, self.fwhm, crop_size, roundlo, roundhi, plot=plot,
                verbose=verbose)
        else:
            raise ValueError("Bad frames detection method not recognized")
        self.good_indices = _host(good)

        index = torch.as_tensor(self.good_indices, dtype=torch.long,
                                device=self.cube.device)
        self.cube = self.cube.index_select(self.cube.ndim - 3, index)
        if verbose:
            print("New cube shape: {}".format(tuple(self.cube.shape)))
        if self.angles is not None:
            self.angles = self.angles[self.good_indices]
            if verbose:
                print("New parallactic angles vector shape: "
                      "{}".format(self.angles.shape))

    def rescale(self, scale, imlib="ndimage", interpolation="bicubic",
                verbose=True):
        """Resample the cube (vip_tpu dataset.py:546)."""
        self.cube = cube_px_resampling(self.cube, scale, imlib,
                                       interpolation, verbose=verbose)
        if self.cube.ndim == 3:
            self.n, self.y, self.x = self.cube.shape

    def subsample(self, window, mode="mean"):
        """Temporally subsample the cube (vip_tpu dataset.py:554)."""
        if self.angles is not None:
            self.cube, self.angles = cube_subsample(
                self.cube, window, mode, parallactic=self.angles)
        else:
            self.cube = cube_subsample(self.cube, window, mode)

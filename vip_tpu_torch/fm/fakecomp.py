"""Fake-companion injection and PSF normalization (port of
``vip_tpu.fm.fakecomp``).

As in vip_tpu, the cubes are injected on the host in float64 numpy: each
companion's shift splits into an integer placement in the frame and a
sub-pixel FFT shift of the small PSF stamp, and the stamps of all frames
shift in one batched ``ops.fft.fourier_shift_batch`` on the default
device (the card unless the caller asked for the CPU). Tensor input is
moved to the host first; results are numpy arrays. The reductions that
inject the same cube many times (contrast curves, completeness) inject on
the card instead, through ``ops.inject.inject_ladder_adi``.

The stamps shift by 'vip-fft' (VIP's padded shift) or 'ndimage-fourier'
(scipy's cyclic shift, NEGFC's default, ``ops.fft.cyclic_fourier_shift``),
either one batch for all frames; the interpolating imlibs wait for
ROADMAP Queue 1, slice 8.
"""

import numpy as np
import torch
from scipy.interpolate import interp1d

from ..config.device import as_tensor
from ..config.utils_conf import check_array
from ..ops.apertures import aperture_flux
from ..ops.fft import cyclic_fourier_shift, fourier_shift_batch
from ..preproc.cosmetics import cube_crop_frames, frame_crop
from ..preproc.derotation import frame_rotate
from ..preproc.recentering import cube_shift, frame_shift
from ..var.coords import dist_matrix, frame_center
from ..var.fit_2d import _airy_fit, _gaussian_fit, _moffat_fit
from ..var.shapes import get_annulus_segments, get_circle

__all__ = ["cube_inject_companions", "generate_cube_copies_with_injections",
           "frame_inject_companion", "collapse_psf_cube", "normalize_psf",
           "cube_planet_free"]

_SLICE8 = "(ROADMAP.md, Queue 1, slice 8)"


def _host(x, dtype=float):
    """Host numpy array of ``x`` (tensors leave their device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _centroid_com(data):
    d = np.asarray(data, dtype=float)
    total = d.sum()
    yy, xx = np.mgrid[: d.shape[0], : d.shape[1]]
    return (d * xx).sum() / total, (d * yy).sum() / total


def _inject_batched_subpx(array_out, fc_fr, angle_list, rad, ang, flevel,
                          imlib_sh):
    """Add the PSF stamps of one companion to every frame of the host cube
    ``array_out`` (vip_tpu fakecomp.py:35): one batched sub-pixel shift
    of the stamps ('vip-fft': pad margin 1; 'ndimage-fourier': cyclic),
    then the integer placement, clipped at the frame edge."""
    sizey, sizex = array_out.shape[-2:]
    size_fc = fc_fr.shape[-1]
    ceny, cenx = frame_center(array_out[0])
    w = int(np.ceil(size_fc / 2))
    if size_fc % 2:
        w -= 1
    sty = int(ceny) - w
    stx = int(cenx) - w

    shift_y = rad * np.sin(ang - np.deg2rad(angle_list))
    shift_x = rad * np.cos(ang - np.deg2rad(angle_list))
    dsy = shift_y - shift_y.astype(int)
    dsx = shift_x - shift_x.astype(int)
    if imlib_sh == "vip-fft":
        shifted = _host(fourier_shift_batch(fc_fr, dsy, dsx, 1))
    else:
        shifted = _host(cyclic_fourier_shift(as_tensor(fc_fr), dsy, dsx))

    for fr in range(array_out.shape[0]):
        y0 = sty + int(shift_y[fr])
        x0 = stx + int(shift_x[fr])
        yN = y0 + size_fc
        xN = x0 + size_fc
        p_y0 = p_x0 = 0
        p_yN = p_xN = size_fc
        if y0 < 0:
            p_y0 = -y0
            y0 = 0
        if x0 < 0:
            p_x0 = -x0
            x0 = 0
        if yN > sizey:
            p_yN -= yN - sizey
            yN = sizey
        if xN > sizex:
            p_xN -= xN - sizex
            xN = sizex
        array_out[fr, y0:yN, x0:xN] += \
            flevel[fr] * shifted[fr, p_y0:p_yN, p_x0:p_xN]
    return array_out


def _extend_transmission(transmission, size):
    """Transmission table extended to cover the radii 0 .. the frame
    diagonal (vip_tpu fakecomp.py:136-155)."""
    t_nz = transmission.shape[0]
    diag = np.sqrt(2) * size
    if transmission[0, 0] == 0 and transmission[0, -1] >= diag:
        return transmission
    trans_rad_list = transmission[0].tolist()
    ntransmission = None
    for j in range(t_nz - 1):
        trans_list = transmission[j + 1].tolist()
        if transmission[0, 0] != 0:
            if j == 0:
                trans_rad_list = [0] + trans_rad_list
            trans_list = [0] + trans_list
        if transmission[0, -1] < np.sqrt(2) * size / 2:
            if j == 0:
                trans_rad_list = trans_rad_list + [diag]
            trans_list = trans_list + [1]
        if j == 0:
            ntransmission = np.zeros([t_nz, len(trans_rad_list)])
            ntransmission[0] = trans_rad_list
        ntransmission[j + 1] = trans_list
    return ntransmission.copy()


def cube_inject_companions(array, psf_template, angle_list, flevel, rad_dists,
                           plsc=None, n_branches=1, theta=0, imlib="vip-fft",
                           interpolation="lanczos4", transmission=None,
                           radial_gradient=False, full_output=False,
                           verbose=False, nproc=1, copy_array=True):
    """Inject fake companions on ``n_branches`` branches at the radii
    ``rad_dists`` of a 3d (ADI) or 4d (IFS+ADI) cube (vip_tpu
    fakecomp.py:91; same parameters and returns, host numpy float64).
    ``transmission`` scales each stamp by the radial transmission, over
    the stamp itself with ``radial_gradient``."""
    check_array(array, dim=(3, 4), msg="array")
    check_array(psf_template, dim=(2, 3), msg="psf_template")
    if array.ndim == 4 and psf_template.ndim != 3:
        raise ValueError("`psf_template` must be a 3d array")
    nframes = array.shape[-3]
    pceny, pcenx = frame_center(psf_template)
    if not np.isscalar(flevel):
        if len(np.asarray(flevel).reshape(-1)) not in (array.shape[0],
                                                       nframes):
            raise TypeError("if not scalar `flevel` must have same length as "
                            "array")
    if imlib in ("opencv", "skimage", "ndimage-interp"):
        raise NotImplementedError(
            f"cube_inject_companions: imlib {imlib!r} is not ported yet "
            f"(only 'vip-fft' and 'ndimage-fourier') {_SLICE8}")
    if imlib not in ("vip-fft", "ndimage-fourier"):
        raise TypeError("Interpolation not recognized.")

    rad_dists = np.asarray(rad_dists).reshape(-1)
    if not rad_dists[-1] < array.shape[-1] / 2:
        raise ValueError("rad_dists last location is at the border (or "
                         "outside) of the field")
    if transmission is not None:
        transmission = np.asarray(transmission, dtype=float)
        t_nz = transmission.shape[0]
        if transmission.ndim != 2:
            raise ValueError("transmission should be a 2D ndarray")
        elif t_nz != 2 and t_nz != 1 + array.shape[0]:
            raise ValueError("transmission dimensions should be (2,N) or "
                             "(n_wave+1, N)")
        transmission = _extend_transmission(transmission, array.shape[-1])

    def _cube_inject_adi(array, psf_template, angle_list, flevel,
                         transmission, verbose, copy_array):
        if np.isscalar(flevel):
            flevel = np.ones_like(angle_list) * flevel
        flevel = np.asarray(flevel, dtype=float)
        if transmission is not None:
            interp_trans = interp1d(transmission[0], transmission[1])
        ceny, cenx = frame_center(array[0])
        size_fc = psf_template.shape[-1]
        fc_fr = np.zeros([nframes, size_fc, size_fc])
        fc_fr[:] = psf_template if psf_template.ndim == 2 \
            else psf_template[:nframes]

        psf_trans = None
        array_out = array.copy() if copy_array else array
        positions = []
        for branch in range(n_branches):
            ang = (branch * 2 * np.pi / n_branches) + np.deg2rad(theta)
            if verbose:
                print(f"Branch {branch + 1}:")
            for rad in rad_dists:
                fc_fr_rad = fc_fr.copy()
                if transmission is not None:
                    if radial_gradient:
                        d = dist_matrix(size_fc, pcenx - rad, pceny)
                        for i in range(d.shape[0]):
                            fc_fr_rad[:, i] = interp_trans(d[i]) * fc_fr[:, i]
                        psf_trans = _host(frame_rotate(
                            fc_fr_rad[0],
                            -(ang * 180 / np.pi - angle_list[0]),
                            imlib="vip-fft", interpolation=interpolation))
                    else:
                        fc_fr_rad = interp_trans(rad) * fc_fr
                if transmission is not None and radial_gradient:
                    # each frame's stamp rotated to its own angle
                    for fr in range(nframes):
                        stamp = _host(frame_rotate(
                            fc_fr_rad[fr],
                            -(ang * 180 / np.pi - angle_list[fr]),
                            imlib="vip-fft", interpolation=interpolation))
                        array_out[fr:fr + 1] = _inject_batched_subpx(
                            array_out[fr:fr + 1], stamp[None],
                            angle_list[fr:fr + 1], rad, ang,
                            flevel[fr:fr + 1], imlib)
                else:
                    array_out = _inject_batched_subpx(
                        array_out, fc_fr_rad, angle_list, rad, ang, flevel,
                        imlib)
                pos_y = rad * np.sin(ang) + ceny
                pos_x = rad * np.cos(ang) + cenx
                positions.append((pos_y, pos_x))
                if verbose:
                    print(f"\t(X,Y)=({pos_x:.2f}, {pos_y:.2f}) "
                          f"({rad:.2f} pxs from center)")
        return array_out, positions, psf_trans

    angle_list = _host(angle_list)
    if array.ndim == 3:
        array_out, positions, psf_trans = _cube_inject_adi(
            _host(array), _host(psf_template), angle_list, flevel,
            transmission, verbose, copy_array)
    else:
        nframes_wav = array.shape[0]
        array_out = _host(array).copy()
        if np.isscalar(flevel):
            flevel_all = np.ones([nframes_wav, nframes]) * flevel
        elif np.asarray(flevel).ndim == 1:
            flevel_all = np.tile(np.asarray(flevel, float)[:, None],
                                 (1, nframes))
        else:
            flevel_all = np.asarray(flevel, float)
        psf_all = _host(psf_template)
        for i in range(nframes_wav):
            if verbose:
                print(f"*** Processing spectral channel {i + 1}/"
                      f"{nframes_wav} ***")
            if transmission is None:
                trans = None
            elif transmission.shape[0] == 2:
                trans = transmission
            else:
                trans = np.array([transmission[0], transmission[i + 1]])
            array_out[i], positions, psf_trans = _cube_inject_adi(
                array_out[i], psf_all[i], angle_list, flevel_all[i], trans,
                verbose=(i == 0 and verbose), copy_array=False)

    if full_output:
        if transmission is not None:
            return array_out, positions, psf_trans
        return array_out, positions
    return array_out


def generate_cube_copies_with_injections(array, psf_template, angle_list,
                                         plsc, n_copies=100, inrad=8,
                                         outrad=12,
                                         dist_flux=("uniform", 2, 500), *,
                                         generator=None):
    """Yield ``n_copies`` copies of the cube, each with one companion at a
    random pixel of the annulus [inrad, outrad) and a random flux from
    ``dist_flux`` (vip_tpu fakecomp.py:262): dicts of positions, dist,
    theta, flux and cube. The draws come from the numpy ``generator``
    when given, else from numpy's global state, as in vip_tpu."""
    from scipy import stats

    yy, xx = get_annulus_segments(array[0] if array.ndim == 3
                                  else array[0, 0], inrad,
                                  outrad - inrad)[0]
    num_patches = yy.shape[0]
    if generator is None:
        draws = dict(skewnormal=stats.skewnorm.rvs, normal=np.random.normal,
                     uniform=np.random.uniform)
        randint = np.random.randint
    else:
        draws = dict(
            skewnormal=lambda *a, size: stats.skewnorm.rvs(
                *a, size=size, random_state=generator),
            normal=generator.normal, uniform=generator.uniform)
        randint = generator.integers
    dist_fkt = draws.get(dist_flux[0], dist_flux[0])
    fluxes = sorted(dist_fkt(*dist_flux[1:], size=n_copies))
    inds_inj = randint(0, num_patches, size=n_copies)

    cy, cx = frame_center(array[0])
    for n in range(n_copies):
        injx = xx[inds_inj[n]] - cx
        injy = yy[inds_inj[n]] - cy
        d = np.sqrt(injx ** 2 + injy ** 2)
        theta = np.mod(np.arctan2(injy, injx) / np.pi * 180, 360)
        fake_cube, positions = cube_inject_companions(
            array, psf_template, angle_list, plsc=plsc, flevel=fluxes[n],
            theta=theta, rad_dists=d, n_branches=1, full_output=True,
            verbose=False)
        yield dict(positions=positions, dist=d, theta=theta, flux=fluxes[n],
                   cube=fake_cube)


def frame_inject_companion(array, array_fc, pos_y, pos_x, flux,
                           imlib="vip-fft", interpolation="lanczos4"):
    """Add ``flux`` times the companion image ``array_fc``, centred at
    (pos_y, pos_x), to a frame or to every frame of a cube (vip_tpu
    fakecomp.py:294). Host numpy float64 out."""
    array = _host(array)
    array_fc = _host(array_fc)
    if array.ndim not in (2, 3):
        raise TypeError("Array is not a 2d or 3d array.")
    size_fc = array_fc.shape[0] if array.ndim == 2 or array_fc.ndim == 1 \
        else array_fc.shape[1]
    ceny, cenx = frame_center(array)
    ceny, cenx = int(ceny), int(cenx)
    fc_fr = np.zeros_like(array)
    w = int(np.floor(size_fc / 2.0))
    odd = size_fc % 2
    fc_fr[..., ceny - w:ceny + w + odd, cenx - w:cenx + w + odd] = array_fc
    shift = frame_shift if array.ndim == 2 else cube_shift
    return array + _host(shift(fc_fr, pos_y - ceny, pos_x - cenx, imlib,
                               interpolation)) * flux


def collapse_psf_cube(array, size, fwhm=4, verbose=True, collapse="mean"):
    """Normalized 2d PSF template from a cube of off-axis frames (vip_tpu
    fakecomp.py:327)."""
    if array.ndim != 3 and array.ndim != 4:
        raise TypeError("Array is not a cube, 3d or 4d array")
    n = array.shape[0]
    psf = _host(cube_crop_frames(array, size=size, verbose=verbose))
    if collapse == "mean":
        psf = np.mean(psf, axis=0)
    elif collapse == "median":
        psf = np.median(psf, axis=0)
    else:
        raise TypeError("Collapse mode not recognized")
    psf_norm = normalize_psf(psf, fwhm=fwhm)
    if verbose:
        print(f"Done scaled PSF template from the average of {n} frames")
    return psf_norm


def normalize_psf(array, fwhm="fit", size=None, threshold=None,
                  mask_core=None, model="gauss", imlib="vip-fft",
                  interpolation="lanczos4", force_odd=True,
                  correct_outliers=True, full_output=False, verbose=True,
                  debug=False):
    """Normalize a PSF frame or cube (vip_tpu fakecomp.py:347): crop to an
    odd size, recentre it to a sub-pixel by 2-d Gaussian fits and FFT
    shifts, and scale the flux in an aperture of diameter ``fwhm`` to 1.
    ``model`` is the 2-d fit of the centring and of ``fwhm='fit'``:
    'gauss', 'moff' (Moffat) or 'airy'. Host numpy out; the fits run
    without pandas."""
    fits = {"gauss": _gaussian_fit, "moff": _moffat_fit, "airy": _airy_fit}
    if model not in fits:
        raise ValueError("`Model` not recognized")
    fit_2d = fits[model]

    def centroid(psf):
        fit = fit_2d(psf, debug=False)
        return fit["centroid_y"], fit["centroid_x"]

    def psf_norm_2d(psf, fwhm, threshold, mask_core, full_output, verbose):
        cy, cx = frame_center(psf, verbose=False)
        xcom, ycom = _centroid_com(psf)
        if not (np.allclose(cy, ycom, atol=1e-2)
                or np.allclose(cx, xcom, atol=1e-2)):
            centry, centrx = centroid(psf)
            if not np.isnan(centry) and not np.isnan(centrx):
                psf = _host(frame_shift(psf, -(centry - cy), -(centrx - cx),
                                        imlib=imlib,
                                        interpolation=interpolation))
                for _ in range(2):
                    centry, centrx = centroid(psf)
                    if np.isnan(centry) or np.isnan(centrx):
                        break
                    cy, cx = frame_center(psf, verbose=False)
                    psf = _host(frame_shift(psf, -(centry - cy),
                                            -(centrx - cx), imlib=imlib,
                                            interpolation=interpolation))

        fwhm_flux = float(aperture_flux(psf, np.array([cy], float),
                                        np.array([cx], float), fwhm / 2)[0])
        if fwhm_flux > 1.1 or fwhm_flux < 0.9:
            psf_norm_array = psf / fwhm_flux
        else:
            psf_norm_array = psf
        if threshold is not None:
            psf_norm_array[np.where(psf_norm_array < threshold)] = 0
        if mask_core is not None:
            psf_norm_array = get_circle(psf_norm_array, radius=mask_core)
        if verbose:
            print(f"Flux in 1xFWHM aperture: {fwhm_flux:.3f}")
        if full_output:
            return psf_norm_array, fwhm_flux, fwhm
        return psf_norm_array

    def fit_fwhm(frame):
        fit = fit_2d(frame, debug=debug)
        if model == "gauss":
            return float(np.mean((fit["fwhm_x"], fit["fwhm_y"])))
        return float(fit["fwhm"])

    def odd_size(size, y):
        if size is not None:
            if force_odd and size % 2 == 0:
                size += 1
                print(f"`Force_odd` is True therefore `size` was set to "
                      f"{size}")
        elif force_odd and y % 2 == 0:
            size = y - 1
            print("`Force_odd` is True and frame size is even, therefore "
                  f"new frame size was set to {size}")
        return size

    array = _host(array)
    if array.ndim == 2:
        size = odd_size(size, array.shape[0])
        if size is not None and size < array.shape[0]:
            array = np.array(frame_crop(array, size, force=True,
                                        verbose=False))
        else:
            array = array.copy()
        if not np.isscalar(fwhm) and fwhm != "fit":
            raise ValueError("For a 2d input array, fwhm should be a scalar "
                             "or string.")
        if isinstance(fwhm, str) and fwhm == "fit":
            fwhm = fit_fwhm(array)
            if verbose:
                print(f"\nMean FWHM: {fwhm:.3f}" if model == "gauss"
                      else f"FWHM: {fwhm:.3f}")
        return psf_norm_2d(array, fwhm, threshold, mask_core, full_output,
                           verbose)

    if array.ndim == 3:
        n = array.shape[0]
        size = odd_size(size, array.shape[1])
        if size is not None and size < array.shape[1]:
            array = np.array(cube_crop_frames(array, size, force=True,
                                              verbose=False))
        if isinstance(fwhm, str) and fwhm == "fit":
            # vip_tpu tests np.isscalar first, which is True for "fit"
            fwhm = np.array([fit_fwhm(array[i]) for i in range(n)])
            if correct_outliers and np.sum(np.isnan(fwhm)) > 0:
                for f in range(n):
                    if np.isnan(fwhm[f]) and f != 0 and f != n - 1:
                        fwhm[f] = np.nanmean([fwhm[f - 1], fwhm[f + 1]])
                    elif np.isnan(fwhm[f]):
                        raise ValueError("2D fit failed for first or last "
                                         "channel. Try other parameters?")
        elif np.isscalar(fwhm):
            fwhm = [fwhm] * n
        elif len(fwhm) != n:
            raise ValueError(f"If fwhm is a list/1darray it should have a "
                             f"length of {n}")
        array_out = []
        fwhm_flux = np.zeros(n)
        for fr in range(n):
            restemp = psf_norm_2d(array[fr], fwhm[fr], threshold, mask_core,
                                  True, False)
            array_out.append(restemp[0])
            fwhm_flux[fr] = restemp[1]
        array_out = np.array(array_out)
        if verbose:
            print("Flux in 1xFWHM aperture: ")
            print(fwhm_flux)
        if full_output:
            return array_out, fwhm_flux, np.asarray(fwhm)
        return array_out
    raise ValueError("Input psf should be 2D or 3D.")


def cube_planet_free(planet_parameter, cube, angs, psfn, imlib="vip-fft",
                     interpolation="lanczos4", transmission=None,
                     radial_gradient=False):
    """The cube with negative companions injected at the known (r, theta,
    flux) of ``planet_parameter`` (vip_tpu fakecomp.py:494)."""
    cube = _host(cube)
    cpf = np.zeros_like(cube)
    planet_parameter = np.array(planet_parameter)
    if (cube.ndim == 3 and planet_parameter.ndim < 2) or \
            (cube.ndim == 4 and planet_parameter.ndim < 3):
        planet_parameter = planet_parameter[np.newaxis, :]
    if cube.ndim == 4 and planet_parameter.shape[2] != cube.shape[0]:
        raise TypeError("Input planet parameter with wrong dimensions.")
    kw = dict(n_branches=1, imlib=imlib, interpolation=interpolation,
              verbose=False, transmission=transmission,
              radial_gradient=radial_gradient)
    for i in range(planet_parameter.shape[0]):
        cube_temp = cube if i == 0 else cpf
        if cube.ndim == 4:
            for j in range(cube.shape[0]):
                cpf[j] = cube_inject_companions(
                    cube_temp[j], psfn[j], angs,
                    flevel=-planet_parameter[i, 2, j],
                    rad_dists=[planet_parameter[i, 0, j]],
                    theta=planet_parameter[i, 1, j], **kw)
        else:
            cpf = cube_inject_companions(
                cube_temp, psfn, angs, flevel=-planet_parameter[i, 2],
                rad_dists=[planet_parameter[i, 0]],
                theta=planet_parameter[i, 1], **kw)
    return cpf

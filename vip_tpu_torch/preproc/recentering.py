"""Sub-pixel shifts and cube recentering (port of
``vip_tpu.preproc.recentering``): ``frame_shift`` and ``cube_shift``
(imlibs 'vip-fft' and 'ndimage-fourier'), the DFT-upsampling
registration, satellite spots, the Radon transform, 2-d fits and speckle
cross-correlation.

'vip-fft' runs ``ops.fft.fourier_shift_batch`` (VIP's padded shift),
'ndimage-fourier' ``ops.fft.cyclic_fourier_shift`` (scipy's cyclic
``fourier_shift`` of the ``fftn``, no pad: the two give different
pixels), both on the tensor's device (numpy input goes to the default
device), and return tensors. The other imlibs (scipy's interpolating
shift, OpenCV) wait for ROADMAP Queue 1, slice 8c.

vip_tpu runs the recentering routines as host loops over frames, grid
points and iterations, one host ``frame_shift`` each. Here every loop of
shifts is one ``cube_shift`` (frames grouped by their pad margin
ceil(max|shift|), which gives each frame what its own ``frame_shift``
gives it); the registration is batched over frames
(``ops.registration``); the small least-squares fits stay on the host
with scipy (``var.fit_2d``), their stamps gathered on the device in one
indexed gather and copied to the host once; the Radon grid search shifts
all the grid points of an iteration at once and reads only the
sinogram's row that its cost reads. Frames and cubes come back as
tensors on their device, shift vectors as numpy. No pandas, and
matplotlib only under ``plot=True``.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..config.utils_conf import check_array
from ..ops.fft import cyclic_fourier_shift, fourier_shift, fourier_shift_batch
from ..stats.clip_sigma import _host
from ..var.coords import frame_center

__all__ = ["frame_shift", "cube_shift", "frame_center_radon",
           "frame_center_satspots", "cube_recenter_2dfit",
           "cube_recenter_dft_upsampling", "cube_recenter_radon",
           "cube_recenter_satspots", "cube_recenter_via_speckles"]

# the frames shifted at once by a grid search (Radon, annulus fit): their
# padded complex canvases (three a frame) under 2 GiB
_GRID_BYTES = 2 << 30


def _only_fft(imlib):
    if imlib not in ("vip-fft", "ndimage-fourier"):
        raise NotImplementedError(
            f"shifts with imlib {imlib!r} are not ported yet (only "
            "'vip-fft' and 'ndimage-fourier'; ROADMAP.md, Queue 1, "
            "slice 8c)")


def frame_shift(array, shift_y, shift_x, imlib="vip-fft",
                interpolation="lanczos4", border_mode="reflect"):
    """Shift a 2d frame by (shift_y, shift_x) px (vip_tpu
    recentering.py:26): 'vip-fft' with VIP's per-call pad margin
    ceil(max|shift|), 'ndimage-fourier' cyclic."""
    check_array(array, dim=2)
    _only_fft(imlib)
    if imlib == "ndimage-fourier":
        return cyclic_fourier_shift(array, float(shift_y), float(shift_x))
    npad = int(np.ceil(np.amax(np.abs([float(shift_y), float(shift_x)]))))
    return fourier_shift(as_tensor(array), shift_y, shift_x, npad)


def cube_shift(cube, shift_y, shift_x, imlib="vip-fft",
               interpolation="lanczos4", border_mode="reflect", nproc=None):
    """Shift every frame of a cube by a scalar or per-frame shift
    (vip_tpu recentering.py:74). 'vip-fft': frames are grouped by their
    own pad margin ceil(max|shift|), as ``frame_shift`` pads each call,
    and each group is one batched shift; 'ndimage-fourier': one batched
    cyclic shift."""
    check_array(cube, dim=3)
    _only_fft(imlib)
    return _grouped_shift(as_tensor(cube), shift_y, shift_x, imlib)


def _grouped_shift(cube, shift_y, shift_x, imlib):
    """The shifts of :func:`cube_shift` of a (B, ny, nx) tensor."""
    n = cube.shape[0]
    shift_y = np.broadcast_to(np.asarray(shift_y, float), (n,)).copy()
    shift_x = np.broadcast_to(np.asarray(shift_x, float), (n,)).copy()
    if imlib == "ndimage-fourier":
        return cyclic_fourier_shift(cube, shift_y, shift_x)
    npads = np.ceil(np.maximum(np.abs(shift_y), np.abs(shift_x))).astype(int)
    out = None
    for npad in np.unique(npads):
        sel = np.nonzero(npads == npad)[0]
        res = fourier_shift_batch(cube[sel], shift_y[sel], shift_x[sel],
                                  int(npad))
        if out is None:
            out = res.new_empty((n,) + tuple(res.shape[1:]))
        out[sel] = res
    return out


def _shift_copies(frame, shift_y, shift_x, imlib="vip-fft"):
    """The ``cube_shift`` of len(shift_y) copies of one frame, in chunks
    whose padded canvases fit ``_GRID_BYTES``: a (G, ny, nx) tensor."""
    G = len(shift_y)
    ny, nx = frame.shape
    npad = int(np.ceil(np.max(np.abs(np.concatenate([shift_y, shift_x])))))
    side = max(ny, nx) + 2 * npad + 1
    chunk = max(1, _GRID_BYTES // (3 * side * side * 2
                                   * frame.element_size()))
    out = frame.new_empty((G, ny, nx))
    for s in range(0, G, chunk):
        e = min(G, s + chunk)
        out[s:e] = _grouped_shift(frame.expand(e - s, ny, nx), shift_y[s:e],
                                  shift_x[s:e], imlib)
    return out


def _square_corner(shape, size, y, x):
    """(y0, y1, x0, x1) of ``get_square(frame, size, y, x)`` of a frame of
    ``shape`` (vip_tpu shapes.py:186): the size takes the frame's parity,
    and a square that leaves the frame raises as there."""
    ny, nx = shape
    if size >= ny and size >= nx:
        raise ValueError("`Size` is equal to or bigger than the initial frame"
                         " size")
    if ny % 2 == 0 and size % 2 != 0:
        size += 1
    elif ny % 2 != 0 and size % 2 == 0:
        size += 1
    wing = (size - 1) / 2
    y0, y1 = int(y - wing), int(y + wing + 1)
    x0, x1 = int(x - wing), int(x + wing + 1)
    if y0 < 0 or x0 < 0 or y1 > ny or x1 > nx:
        raise RuntimeError(
            f"square cannot be obtained with size={size}, y={y}, x={x}")
    return y0, y1, x0, x1


def _gather_squares(frames, fidx, y0, x0, size):
    """The (K, size, size) squares of ``frames`` (B, ny, nx) at frame
    ``fidx[k]``, corner (y0[k], x0[k]): one indexed gather on the frames'
    device, copied to the host once (numpy)."""
    ny, nx = frames.shape[-2:]
    dev = frames.device
    d = torch.arange(size, device=dev)
    fi, yi, xi = (torch.as_tensor(np.asarray(v, dtype=np.int64), device=dev)
                  for v in (fidx, y0, x0))
    flat = (fi[:, None, None] * (ny * nx) + (yi[:, None, None] + d[:, None])
            * nx + xi[:, None, None] + d[None, :])
    return _host(frames.reshape(-1)[flat])


def _plot_shifts(shift_x, shift_y, extra=None):
    """The two diagnostic figures every cube_recenter_* draws when
    plot=True (vip_tpu recentering.py:115): per-frame shift curves and
    shift histograms."""
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 4))
    plt.plot(shift_x, "o-", label="Shifts in x", alpha=0.5)
    plt.plot(shift_y, "o-", label="Shifts in y", alpha=0.5)
    plt.legend(loc="best")
    plt.grid("on", alpha=0.2)
    plt.ylabel("Pixels")
    plt.xlabel("Frame number")

    plt.figure(figsize=(8, 4))
    b = max(1, int(np.sqrt(len(shift_x))))
    plt.hist(shift_x, bins=b, alpha=0.5, label="Histogram shifts X")
    plt.hist(shift_y, bins=b, alpha=0.5, label="Histogram shifts Y")
    if extra is not None:
        for vec, lab in extra:
            plt.hist(vec, bins=b, alpha=0.5, label=f"Histogram {lab}")
    plt.legend(loc="best")
    plt.ylabel("Bin counts")
    plt.xlabel("Pixels")


def _float_cube(array):
    array = as_tensor(array)
    return array if array.is_floating_point() else array.to(torch.float64)


def cube_recenter_dft_upsampling(array, center_fr1=None, negative=False,
                                 fwhm=4, subi_size=None, upsample_factor=100,
                                 imlib="vip-fft", interpolation="lanczos4",
                                 mask=None, border_mode="reflect",
                                 log=False, collapse="median",
                                 full_output=False, verbose=True, nproc=None,
                                 save_shifts=False, debug=False, plot=True):
    """Register a cube against its first frame by upsampled
    cross-correlation ([GUI08]; vip_tpu recentering.py:141), every frame
    at once (``ops.registration``), or with ``mask`` by the masked
    normalized cross-correlation (Padfield 2012), also batched. With
    ``subi_size``, a 2-d Gaussian fit of the collapsed registered cube
    (the median through CUDA kernel H1 on the card) centers the whole
    sequence. Returns the recentered cube (a tensor), and with
    ``full_output`` the y and x shifts (numpy)."""
    from ..ops.registration import (dft_registration_batch,
                                    masked_register_translation)

    check_array(array, dim=3)
    array = _float_cube(array)
    n = array.shape[0]
    cy, cx = frame_center(array[0])

    if mask is not None and tuple(mask.shape) != tuple(array.shape[-2:]):
        raise TypeError("If provided, mask should have same shape as "
                        "frames")
    if subi_size is not None:
        if center_fr1 is None:
            print("`center_fr1` not provided")
            print("Using the coordinates of the 1st frame center for "
                  "the Gaussian 2d fit")
            cy_1, cx_1 = frame_center(array[0])
        else:
            cy_1, cx_1 = center_fr1
        if not isinstance(subi_size, int):
            raise ValueError("subi_size must be an integer or None")
        if subi_size < fwhm:
            raise ValueError("`subi_size` (value in pixels) is too small")
        if array.shape[-1] % 2 == subi_size % 2:
            subi_size += 1

    array_reg = array
    if log:
        nanmin = torch.where(torch.isnan(array), torch.inf, array).min()
        array_reg = torch.log(array - (nanmin - 1))

    shifts = np.zeros((n, 2))
    if n > 1:
        if mask is not None:
            shifts[1:] = masked_register_translation(
                array_reg[0], array_reg[1:], _host(mask))
        else:
            shifts[1:] = _host(dft_registration_batch(
                array_reg[0], array_reg[1:],
                upsample_factor=int(upsample_factor)))
    y = shifts[:, 0].copy()
    x = shifts[:, 1].copy()

    if subi_size is not None:
        from .subsampling import cube_collapse

        array_shifted = cube_shift(array, y, x, imlib=imlib,
                                   interpolation=interpolation,
                                   border_mode=border_mode)
        marray_al = cube_collapse(array_shifted, mode=collapse)
        del array_shifted
        y1, x1 = _centroid_2dg_frame([marray_al], 0, subi_size, cy_1, cx_1,
                                     negative, debug, fwhm)
        x[:] += cx - x1
        y[:] += cy - y1
        if verbose:
            print("Shift for first frame X,Y=({:.3f}, {:.3f})".format(
                x[0], y[0]))

    array_rec = cube_shift(array, y, x, imlib=imlib,
                           interpolation=interpolation,
                           border_mode=border_mode)
    if verbose:
        print("Median shifts: dy={:.3f}, dx={:.3f}".format(np.median(y),
                                                           np.median(x)))
    if plot:
        _plot_shifts(x, y)
    if save_shifts:
        np.savetxt("recent_dft_shifts.txt", np.transpose([y, x]), fmt="%f")
    if full_output:
        return array_rec, y, x
    return array_rec


# ----------------------------------------------------------------------
# satellite-spot centering


def _satspots_centroids(frames, xys, subi_size, sigfactor, fit_type,
                        filter_freq, debug):
    """The filtered frames of a (B, ny, nx) batch (one batched high-pass
    and low-pass call) and the fitted (y, x) centroids (B, 4) of their
    four spots at ``xys[b][i]`` = (x, y): the 4B stamps gathered at once,
    then fitted on the host in frame then spot order (vip_tpu
    recentering.py:240-290)."""
    from ..var.filters import cube_filter_highpass, cube_filter_lowpass
    from ..var.fit_2d import _gaussian_fit, _moffat_fit

    if filter_freq[0] > 0:
        frames = cube_filter_highpass(frames, mode="gauss-subt",
                                      fwhm_size=filter_freq[0])
    if filter_freq[1] > 0:
        frames = cube_filter_lowpass(frames, fwhm_size=filter_freq[1])
    B = frames.shape[0]
    corners = np.array([[_square_corner(frames.shape[-2:], subi_size,
                                        xys[b][i][1], xys[b][i][0])
                         for i in range(4)] for b in range(B)])
    size = int(corners[0, 0, 1] - corners[0, 0, 0])
    stamps = _gather_squares(frames, np.repeat(np.arange(B), 4),
                             corners[..., 0].ravel(),
                             corners[..., 2].ravel(), size)
    fit = _gaussian_fit if fit_type == "gaus" else _moffat_fit
    centy = np.zeros((B, 4))
    centx = np.zeros((B, 4))
    for k, sim in enumerate(stamps):
        b, i = divmod(k, 4)
        res = fit(sim, crop=False, threshold=True, sigfactor=sigfactor,
                  debug=debug)
        centy[b, i] = res["centroid_y"] + corners[b, i, 0]
        centx[b, i] = res["centroid_x"] + corners[b, i, 2]
    return frames, centy, centx


def _satspots_shift(centy, centx, cy, cx, debug, verbose):
    """The (shifty, shiftx) that brings the intersection of the spots'
    diagonals (Cramer's rule) to (cy, cx) (vip_tpu
    recentering.py:255-318)."""
    def line(p1, p2):
        A = p1[1] - p2[1]
        B = p2[0] - p1[0]
        C = p1[0] * p2[1] - p2[0] * p1[1]
        return A, B, -C

    def intersection(L1, L2):
        D = L1[0] * L2[1] - L1[1] * L2[0]
        Dx = L1[2] * L2[1] - L1[1] * L2[2]
        Dy = L1[0] * L2[2] - L1[2] * L2[0]
        if D != 0:
            return Dx / D, Dy / D
        return None

    L1 = line([centx[0], centy[0]], [centx[3], centy[3]])
    L2 = line([centx[1], centy[1]], [centx[2], centy[2]])
    R = intersection(L1, L2)
    msgerr = "Check that the order of the tuples in `xy` is correct and" \
             " the satellite spots have good S/N"
    if R is None:
        raise RuntimeError("Something went wrong, no intersection found. "
                           + msgerr)
    shiftx = cx - R[0]
    shifty = cy - R[1]
    if not (np.abs(shiftx) < cx * 2 and np.abs(shifty) < cy * 2):
        raise RuntimeError("Too large shifts. " + msgerr)
    if debug or verbose:
        print("Intersection coordinates (X,Y):", R[0], R[1], "\n")
        print("Shifts (X,Y): {:.3f}, {:.3f}".format(shiftx, shifty))
    return shifty, shiftx


def _check_satspots(fit_type, xy):
    if fit_type not in ["gaus", "moff"]:
        raise TypeError("fit_type is not recognized")
    if not isinstance(xy, (tuple, list)) or len(xy) != 4:
        raise TypeError("Input waffle spot coordinates in wrong format "
                        "(must be a tuple of 4 tuples")


def frame_center_satspots(array, xy, subi_size=19, sigfactor=6, shift=False,
                          fit_type="moff", filter_freq=(0, 0),
                          border_mode="reflect", imlib="vip-fft",
                          interpolation="lanczos4", debug=False,
                          verbose=True):
    """The frame center from four satellite spots (vip_tpu
    recentering.py:240): 2-d fits of the spots on the host, then the
    intersection of the two diagonals. Returns (shifty, shiftx), or with
    ``shift`` (the shifted frame, shifty, shiftx, centy, centx); as in
    vip_tpu, with ``filter_freq`` the frame shifted is the filtered one."""
    check_array(array, dim=2)
    _check_satspots(fit_type, xy)
    frame = as_tensor(array)
    cy, cx = frame_center(frame)
    filt, centy, centx = _satspots_centroids(
        frame[None], [xy], subi_size, sigfactor, fit_type, filter_freq,
        debug)
    shifty, shiftx = _satspots_shift(centy[0], centx[0], cy, cx, debug,
                                     verbose)
    if shift:
        array_rec = frame_shift(filt[0], shifty, shiftx, imlib=imlib,
                                interpolation=interpolation,
                                border_mode=border_mode)
        return array_rec, shifty, shiftx, list(centy[0]), list(centx[0])
    return shifty, shiftx


def cube_recenter_satspots(array, xy, subi_size=19, sigfactor=6, plot=True,
                           fit_type="moff", lbda=None, filter_freq=(0, 0),
                           border_mode="constant", imlib="vip-fft",
                           interpolation="lanczos4", debug=False,
                           verbose=True, full_output=False):
    """Recenter a cube on the satellite spots of every frame (vip_tpu
    recentering.py:321): every frame filtered in one batched call, the
    4·n spots fitted on the host, every frame shifted in one
    ``cube_shift``. With ``lbda`` the spots' positions scale with
    wavelength about the frame center. Returns the recentered (filtered)
    cube, and with ``full_output`` the shifts and the spots' y and x."""
    check_array(array, dim=3)
    _check_satspots(fit_type, xy)
    cube = as_tensor(array)
    n_frames = cube.shape[0]
    cy, cx = frame_center(cube[0])
    if lbda is not None:
        rescal = np.asarray(lbda) / lbda[0]
        final_xy = [tuple((cx + rescal[i] * (xy[s][0] - cx),
                           cy + rescal[i] * (xy[s][1] - cy))
                          for s in range(4)) for i in range(n_frames)]
    else:
        final_xy = [xy for _ in range(n_frames)]
    if verbose:
        print("Final xy positions for sat spots:", final_xy)
        print("Looping through the frames, fitting the intersections:")
    filt, sat_y, sat_x = _satspots_centroids(
        cube, final_xy, subi_size, sigfactor, fit_type, filter_freq, debug)
    shift_y = np.zeros(n_frames)
    shift_x = np.zeros(n_frames)
    for i in range(n_frames):
        shift_y[i], shift_x[i] = _satspots_shift(sat_y[i], sat_x[i], cy, cx,
                                                 debug, False)
    array_rec = cube_shift(filt, shift_y, shift_x, imlib=imlib,
                           interpolation=interpolation,
                           border_mode=border_mode)
    if verbose:
        print("MEAN X,Y: {:.3f}, {:.3f}".format(np.mean(shift_x),
                                                np.mean(shift_y)))
        print("MEDIAN X,Y: {:.3f}, {:.3f}".format(np.median(shift_x),
                                                  np.median(shift_y)))
        print("STDDEV X,Y: {:.3f}, {:.3f}".format(np.std(shift_x),
                                                  np.std(shift_y)))
    if plot:
        _plot_shifts(shift_x, shift_y)
    if full_output:
        return array_rec, shift_y, shift_x, sat_y, sat_x
    return array_rec


# ----------------------------------------------------------------------
# radon-transform centering ([PUE15])


def _rotated_coords(n, theta, cols=None):
    """Bilinear sample coordinates of skimage's ``radon`` warp (order 1,
    about n // 2) of an n x n image for each angle of ``theta`` (degrees),
    at the columns ``cols`` of the rotated image (all by default): float64
    (T, n, C) source x and y."""
    center = n // 2
    a = np.deg2rad(np.atleast_1d(np.asarray(theta, dtype=float)))
    cos_a = torch.as_tensor(np.cos(a))[:, None, None]
    sin_a = torch.as_tensor(np.sin(a))[:, None, None]
    y0 = torch.arange(n, dtype=torch.float64)[None, :, None] - center
    cols = np.arange(n) if cols is None else np.asarray(cols)
    x0 = torch.as_tensor(cols, dtype=torch.float64)[None, None, :] - center
    xs = cos_a * x0 + sin_a * y0 + center
    ys = -sin_a * x0 + cos_a * y0 + center
    return xs, ys


def _bilinear_column_sums(images, xs, ys):
    """Σ over the rows of the bilinear samples of each image of a (B, n,
    n) batch at the (T, n, C) coordinates (zero outside): (B, T, C), as
    vip_tpu's ``radon`` sums its rotated image (recentering.py:383)."""
    B, n, _ = images.shape
    dev, dt = images.device, images.dtype
    xs, ys = xs.to(dev), ys.to(dev)
    x0f = torch.floor(xs)
    y0f = torch.floor(ys)
    wx = (xs - x0f).to(dt)
    wy = (ys - y0f).to(dt)
    x0f = x0f.long()
    y0f = y0f.long()
    flat = images.reshape(B, -1)

    def sample(yi, xi):
        valid = (yi >= 0) & (yi < n) & (xi >= 0) & (xi < n)
        idx = yi.clamp(0, n - 1) * n + xi.clamp(0, n - 1)
        vals = flat[:, idx.reshape(-1)].reshape(B, *idx.shape)
        return torch.where(valid, vals, 0.0)

    rot = ((1 - wy) * (1 - wx) * sample(y0f, x0f)
           + (1 - wy) * wx * sample(y0f, x0f + 1)
           + wy * (1 - wx) * sample(y0f + 1, x0f)
           + wy * wx * sample(y0f + 1, x0f + 1))
    return rot.sum(dim=-2)


def radon(image, theta, circle=True):
    """Radon transform (skimage.transform.radon semantics: an order-1 warp
    about shape // 2, column sums; vip_tpu recentering.py:383) of a square
    image, all angles in one batched bilinear gather on the image's
    device. Returns the (n, len(theta)) sinogram as numpy."""
    img = as_tensor(image)
    if not img.is_floating_point():
        img = img.to(torch.float64)
    xs, ys = _rotated_coords(img.shape[0], theta)
    return _host(_bilinear_column_sums(img[None], xs, ys)[0].T)


def _satspots_theta(satspots_cfg, theta_0, delta_theta, samples=10):
    """Angle samples around the satellite-spot directions (vip_tpu
    recentering.py:423)."""
    if satspots_cfg == "+":
        starts = [0, 90, 180, 270]
    elif satspots_cfg == "x":
        starts = [45, 135, 225, 315]
    elif satspots_cfg == "custom":
        starts = [theta_0, theta_0 + 90, theta_0 + 180, theta_0 + 270]
    else:
        raise ValueError("If not None, satspots_cfg can only be 'x', '+' "
                         "or 'custom'.")
    return np.hstack([np.linspace(s - delta_theta, s + delta_theta,
                                  samples, endpoint=False) for s in starts])


def _radon_theta(n, satspots_cfg, theta_0, delta_theta):
    if satspots_cfg is None:
        return np.linspace(0, 360, num=n, endpoint=False)
    return _satspots_theta(satspots_cfg, theta_0, delta_theta)


def _quarter_cost(row):
    """``np.nansum`` of the ``np.nanmax`` of each quarter of the angles of
    a sinogram row (..., T) (vip_tpu recentering.py:461-464)."""
    qstep = row.shape[-1] // 4
    q = row[..., :4 * qstep].reshape(*row.shape[:-1], 4, qstep)
    nan = torch.isnan(q)
    mx = torch.where(nan, -torch.inf, q).amax(dim=-1)
    mx = torch.where(nan.all(dim=-1), torch.nan, mx)
    return torch.nansum(mx, dim=-1)


def _radon_costf(frame, cent, radint, coords, satspots_cfg=None, theta_0=0,
                 delta_theta=5, imlib="vip-fft", interpolation="lanczos4"):
    """The Radon cost of one grid point (vip_tpu recentering.py:445): the
    frame shifted by ``coords``, its annulus [radint, cent), the whole
    sinogram, then the quarters of its row ``int(cent)``. The plain
    version of ``_radon_costs``."""
    from ..var.shapes import get_annulus_segments

    frame_shifted = frame_shift(frame, coords[0], coords[1], imlib=imlib,
                                interpolation=interpolation)
    frame_shifted_ann = get_annulus_segments(frame_shifted, radint,
                                             cent - radint, mode="mask")[0]
    theta = _radon_theta(frame_shifted_ann.shape[0], satspots_cfg, theta_0,
                         delta_theta)
    sinogram = radon(frame_shifted_ann, theta=theta, circle=True)
    row = torch.as_tensor(sinogram[int(cent)])
    return float(_quarter_cost(row))


def _ring_mask(shape, radint, cent, device, dtype):
    from ..var.shapes import get_annulus_segments

    yy, xx = get_annulus_segments(shape, radint, cent - radint)[0]
    ring = torch.zeros(shape, dtype=dtype, device=device)
    ring[torch.as_tensor(yy, device=device),
         torch.as_tensor(xx, device=device)] = 1
    return ring


def _radon_costs(frame, cent, radint, coords, satspots_cfg=None, theta_0=0,
                 delta_theta=5, imlib="vip-fft"):
    """:func:`_radon_costf` of every grid point of ``coords`` (G, 2) at
    once: the G shifted frames in one ``cube_shift`` (chunked), and of
    each angle's rotated image the column ``int(cent)`` alone, the one the
    cost reads (n bilinear samples an angle, not n²). Returns (G,) costs
    as numpy."""
    frame = as_tensor(frame)
    n = frame.shape[0]
    coords = np.asarray(coords, dtype=float).reshape(-1, 2)
    shifted = _shift_copies(frame, coords[:, 0], coords[:, 1], imlib)
    shifted = shifted * _ring_mask(tuple(frame.shape), radint, cent,
                                   frame.device, frame.dtype)
    theta = _radon_theta(n, satspots_cfg, theta_0, delta_theta)
    xs, ys = _rotated_coords(n, theta, cols=[int(cent)])
    row = _bilinear_column_sums(shifted, xs, ys)[..., 0]
    return _host(_quarter_cost(row))


def frame_center_radon(array, cropsize=None, hsize_ini=1., step_ini=0.1,
                       n_iter=5, tol=0.1, mask_center=None, nproc=None,
                       satspots_cfg=None, theta_0=0, delta_theta=5,
                       gauss_fit=True, hpf=True, filter_fwhm=8,
                       imlib="vip-fft", interpolation="lanczos4",
                       full_output=False, verbose=True, plot=True,
                       debug=False):
    """The star center behind a coronagraph by an iterative Radon-cost
    grid search ([PUE15]; vip_tpu recentering.py:467): each iteration's
    grid in one batched call (``_radon_costs``), the peak from a 2-d
    Gaussian fit of the cost map (host scipy, no pandas) or its argmax.
    Returns the star's (optimy, optimx), and with ``full_output`` the
    uncertainty (dy, dx) and the last cost map."""
    from ..var.filters import frame_filter_highpass
    from ..var.fit_2d import _gaussian_fit
    from ..var.shapes import get_annulus_segments
    from .cosmetics import frame_crop

    if array.ndim != 2:
        raise TypeError("Input array is not a frame or 2d array")

    def _center_radon(array, cropsize, hsize, step):
        frame = array.clone()
        ori_cent_y, ori_cent_x = frame_center(frame)
        if cropsize is not None:
            if not cropsize % 2:
                raise TypeError("If not None, cropsize should be odd "
                                "integer")
            frame = frame_crop(frame, cropsize, verbose=False)
        listyx = np.linspace(start=-hsize, stop=hsize,
                             num=int(2 * hsize / step) + 1, endpoint=True)
        if not mask_center:
            radint = 0
        else:
            if not isinstance(mask_center, int):
                raise TypeError
            radint = mask_center
        coords = [(y, x) for y in listyx for x in listyx]
        cent, _ = frame_center(frame)
        frame = get_annulus_segments(frame, radint, cent - radint,
                                     mode="mask")[0]
        costf = _radon_costs(frame, cent, radint, coords, satspots_cfg,
                             theta_0, delta_theta, imlib)
        cost_bound = costf.reshape(listyx.shape[0], listyx.shape[0])

        if plot:
            import matplotlib.pyplot as plt

            plt.contour(cost_bound, cmap="CMRmap", origin="lower")
            plt.imshow(cost_bound, cmap="CMRmap", origin="lower",
                       interpolation="nearest")
            plt.colorbar()
            plt.grid("off")
            plt.show()

        if gauss_fit:
            fit_res = _gaussian_fit(cost_bound - np.amin(cost_bound),
                                    crop=False, threshold=False, sigfactor=3,
                                    debug=debug)
            opt_yshift = -hsize + fit_res["centroid_y"] * step
            opt_xshift = -hsize + fit_res["centroid_x"] * step
            dyx = (fit_res["fwhm_y"] * step, fit_res["fwhm_x"] * step)
        else:
            argm = np.argmax(costf)
            opt_yshift, opt_xshift = coords[argm]
            dyx = (step, step)

        optimy = ori_cent_y - opt_yshift
        optimx = ori_cent_x - opt_xshift
        if verbose:
            print("Cost function max: {}".format(costf.max()))
            print("Finished grid search radon optimization: dy={:.3f}, "
                  "dx={:.3f}".format(opt_yshift, opt_xshift))
        return optimy, optimx, opt_yshift, opt_xshift, dyx, cost_bound

    array = as_tensor(array)
    if hpf:
        array = frame_filter_highpass(array, mode="gauss-subt",
                                      fwhm_size=filter_fwhm)

    ori_cent_y, ori_cent_x = frame_center(array)
    hsize = hsize_ini
    step = step_ini
    opt_yshift = 0
    opt_xshift = 0
    dyx = (step, step)
    cost_bound = None
    for i in range(n_iter):
        if verbose:
            print("*** Iteration {}/{} ***".format(i + 1, n_iter))
        res = _center_radon(array, cropsize, hsize, step)
        _, _, y_shift, x_shift, dyx, cost_bound = res
        array = frame_shift(array, y_shift, x_shift, imlib=imlib,
                            interpolation=interpolation)
        opt_yshift += y_shift
        opt_xshift += x_shift

        abs_shift = np.sqrt(y_shift ** 2 + x_shift ** 2)
        if abs_shift < tol:
            if i == 0:
                raise ValueError("Null shifts found at first iteration for "
                                 "step = {}. Try with a finer step."
                                 .format(step))
            print("Convergence found after {} iterations (final step = {})."
                  .format(i + 1, step))
            break
        hsize *= 0.75
        step *= 0.75

    # the star sits where the summed shifts brought to the center: vip_tpu
    # adds them (recentering.py:581-582) and returns the center's mirror
    # image (ROADMAP Queue 3)
    optimy = ori_cent_y - opt_yshift
    optimx = ori_cent_x - opt_xshift
    if verbose:
        print("Star (x,y) location: {:.2f}, {:.2f}".format(optimx, optimy))
        print("Final (x,y) shifts: {:.2f}, {:.2f}".format(opt_xshift,
                                                          opt_yshift))
    if full_output:
        return optimy, optimx, dyx, cost_bound
    return optimy, optimx


def cube_recenter_radon(array, full_output=False, verbose=True,
                        imlib="vip-fft", interpolation="lanczos4",
                        border_mode="reflect", nproc=None, **kwargs):
    """Recenter a cube with the Radon method (vip_tpu
    recentering.py:592): each frame's search through
    :func:`frame_center_radon` (its grids batched), then every frame
    shifted in one ``cube_shift``. Returns the recentered cube, and with
    ``full_output`` the y and x shifts and the (n, 2) uncertainties."""
    check_array(array, dim=3)
    cube = as_tensor(array)
    n_frames = cube.shape[0]
    x = np.zeros(n_frames)
    y = np.zeros(n_frames)
    dyx = np.zeros((n_frames, 2))
    cy, cx = frame_center(cube[0])
    for i in range(n_frames):
        res = frame_center_radon(cube[i], verbose=False, plot=False,
                                 imlib=imlib, interpolation=interpolation,
                                 full_output=True, nproc=nproc, **kwargs)
        y[i] = res[0]
        x[i] = res[1]
        dyx[i] = res[2]
    array_rec = cube_shift(cube, cy - y, cx - x, imlib=imlib,
                           interpolation=interpolation,
                           border_mode=border_mode)
    if full_output:
        return array_rec, y - cy, x - cx, dyx
    return array_rec


# ----------------------------------------------------------------------
# 2-d fit centering


def _stamp_centroid(model, sub_image, negative, debug, fwhm, threshold,
                    sigfactor):
    """(y, x) centroid of a host stamp by a 2-d Gaussian, Moffat or Airy
    fit (vip_tpu recentering.py:623-706)."""
    from ..var.fit_2d import _airy_fit, _gaussian_fit, _moffat_fit

    sub_image = np.asarray(_host(sub_image), dtype=float)
    if negative:
        sub_image = -sub_image + np.abs(np.min(-sub_image))
    if model == "gauss":
        res = _gaussian_fit(sub_image, crop=False, fwhmx=fwhm, fwhmy=fwhm,
                            threshold=threshold, sigfactor=sigfactor,
                            debug=debug)
    elif model == "moff":
        res = _moffat_fit(sub_image, crop=False, fwhm=fwhm,
                          threshold=threshold, sigfactor=sigfactor,
                          debug=debug)
    else:
        res = _airy_fit(sub_image, crop=False, fwhm=fwhm,
                        threshold=threshold, sigfactor=sigfactor,
                        debug=debug)
    return res["centroid_y"], res["centroid_x"]


def _frame_centroid(model, cube, frnum, size, pos_y, pos_x, negative, debug,
                    fwhm, threshold, sigfactor):
    from ..var.shapes import get_square

    sub_image, y1, x1 = get_square(cube[frnum], size=size, y=pos_y, x=pos_x,
                                   position=True)
    y_i, x_i = _stamp_centroid(model, sub_image, negative, debug, fwhm,
                               threshold, sigfactor)
    return y1 + y_i, x1 + x_i


def _centroid_2dg_frame(cube, frnum, size, pos_y, pos_x, negative, debug,
                        fwhm, threshold=False, sigfactor=1):
    """2-d Gaussian centroid of one frame (vip_tpu recentering.py:623)."""
    return _frame_centroid("gauss", cube, frnum, size, pos_y, pos_x,
                           negative, debug, fwhm, threshold, sigfactor)


def _centroid_2dm_frame(cube, frnum, size, pos_y, pos_x, negative, debug,
                        fwhm, threshold=False, sigfactor=1):
    """2-d Moffat centroid of one frame (vip_tpu recentering.py:643)."""
    return _frame_centroid("moff", cube, frnum, size, pos_y, pos_x,
                           negative, debug, fwhm, threshold, sigfactor)


def _centroid_2da_frame(cube, frnum, size, pos_y, pos_x, negative, debug,
                        fwhm, threshold=False, sigfactor=1):
    """2-d Airy centroid of one frame (vip_tpu recentering.py:662)."""
    return _frame_centroid("airy", cube, frnum, size, pos_y, pos_x,
                           negative, debug, fwhm, threshold, sigfactor)


def _2g_params(fwhm, params_2g):
    fwhm_neg, fwhm_pos = 0.8 * fwhm, 2 * fwhm
    theta_neg, theta_pos, neg_amp = 0., 0., 1
    if isinstance(params_2g, dict):
        fwhm_neg = params_2g.get("fwhm_neg", 0.8 * fwhm)
        fwhm_pos = params_2g.get("fwhm_pos", 2 * fwhm)
        theta_neg = params_2g.get("theta_neg", 0.)
        theta_pos = params_2g.get("theta_pos", 0.)
        neg_amp = params_2g.get("neg_amp", 1)
    return dict(fwhm_neg=fwhm_neg, fwhm_pos=fwhm_pos, theta_neg=theta_neg,
                theta_pos=theta_pos, neg_amp=neg_amp)


def _2g_stamp_result(sub_image, y0, x0, pos_y, pos_x, debug, fwhm, fix_neg,
                     params_2g, threshold, sigfactor):
    """The double-Gaussian fit of a stamp cut at (y0, x0) about (pos_y,
    pos_x), through the port's pandas-free fit (``var.fit_2d``), in frame
    coordinates: (y, x), or with ``fix_neg`` False the twelve columns of
    vip_tpu's tuple (recentering.py:694-705)."""
    from ..var.fit_2d import _2gauss_fit

    res = _2gauss_fit(np.asarray(_host(sub_image), dtype=float), crop=False,
                      cent=(pos_x - x0, pos_y - y0), fix_neg=fix_neg,
                      threshold=threshold, sigfactor=sigfactor, debug=debug,
                      **_2g_params(fwhm, params_2g))
    y_i = res["centroid_y"] + y0
    x_i = res["centroid_x"] + x0
    if not fix_neg:
        return (y_i, x_i, res["centroid_y_neg"] + y0,
                res["centroid_x_neg"] + x0, res["fwhm_x"], res["fwhm_y"],
                res["fwhm_x_neg"], res["fwhm_y_neg"], res["theta"],
                res["theta_neg"], res["amplitude"], res["amplitude_neg"])
    return y_i, x_i


def _centroid_2d2g_frame(cube, frnum, size, pos_y, pos_x, debug=False,
                         fwhm=4, fix_neg=True, params_2g=None,
                         threshold=False, sigfactor=1):
    """2-d double-Gaussian centroid of one frame (vip_tpu
    recentering.py:681); without pandas."""
    frame = cube[frnum]
    size = min(frame.shape[0], frame.shape[1], size)
    y0, y1, x0, x1 = _square_corner(tuple(frame.shape[-2:]), size, pos_y,
                                    pos_x)
    sub = frame[y0:y1, x0:x1]
    return _2g_stamp_result(sub, y0, x0, pos_y, pos_x, debug, fwhm, fix_neg,
                            params_2g, threshold, sigfactor)


def cube_recenter_2dfit(array, xy=None, fwhm=4, subi_size=5, model="gauss",
                        nproc=1, imlib="vip-fft", interpolation="lanczos4",
                        offset=None, negative=False, threshold=False,
                        sigfactor=2, fix_neg=False, params_2g=None,
                        border_mode="reflect", save_shifts=False,
                        full_output=False, verbose=True, debug=False,
                        plot=True):
    """Recenter a cube with a 2-d fit of every frame ('gauss', 'moff',
    'airy' or '2gauss'; vip_tpu recentering.py:709): the frames' stamps
    gathered on the device at once and copied to the host, the fits there
    in frame order (scipy), every frame shifted in one ``cube_shift``.
    Returns the recentered cube, and with ``full_output`` the y and x
    shifts (and with '2gauss' and ``fix_neg`` False vip_tpu's columns of
    the negative Gaussian)."""
    if verbose:
        from ..config import time_ini, timing
        start_time = time_ini()
    check_array(array, dim=3)
    cube = as_tensor(array)
    n_frames, sizey, sizex = cube.shape
    if not isinstance(subi_size, int):
        raise ValueError("`subi_size` must be an integer")
    if sizey % 2 == 0:
        if subi_size % 2 != 0:
            subi_size += 1
            print("`subi_size` is odd (while frame size is even)")
            print("Setting `subi_size` to {} pixels".format(subi_size))
    else:
        if subi_size % 2 == 0:
            subi_size += 1
            print("`subi_size` is even (while frame size is odd)")
            print("Setting `subi_size` to {} pixels".format(subi_size))
    if isinstance(fwhm, (float, int, np.float32, np.float64)):
        fwhm = np.ones(n_frames) * fwhm
    if debug and cube.shape[0] > 20:
        raise RuntimeWarning("Debug with a big array will produce a very "
                             "long output. Try with less than 20 frames in "
                             "debug mode")
    if xy is not None:
        pos_x, pos_y = xy
        cond = model != "2gauss"
        if (not isinstance(pos_x, int) or not isinstance(pos_y, int)) \
                and cond:
            raise TypeError("`xy` must be a tuple of integers")
    else:
        pos_y, pos_x = frame_center(cube[0])
    cy, cx = frame_center(cube[0])
    if model not in ("gauss", "moff", "airy", "2gauss"):
        raise ValueError("model not recognized")
    if verbose:
        print("2d {}-fitting".format(model))

    size = min(sizey, sizex, subi_size) if model == "2gauss" else subi_size
    y0, y1, x0, x1 = _square_corner((sizey, sizex), size, pos_y, pos_x)
    stamps = _host(cube[:, y0:y1, x0:x1])
    if model == "2gauss":
        res = [_2g_stamp_result(stamps[i], y0, x0, pos_y, pos_x, debug,
                                fwhm[i], fix_neg, params_2g, threshold,
                                sigfactor) for i in range(n_frames)]
    else:
        res = []
        for i in range(n_frames):
            y_i, x_i = _stamp_centroid(model, stamps[i], negative, debug,
                                       fwhm[i], threshold, sigfactor)
            res.append((y0 + y_i, x0 + x_i))
    res = np.array(res, dtype=float)

    y = cy - res[:, 0]
    x = cx - res[:, 1]
    two_neg = model == "2gauss" and not fix_neg
    if two_neg:
        (y_neg, x_neg, fwhm_x, fwhm_y, fwhm_neg_x, fwhm_neg_y, theta,
         theta_neg, amp_pos, amp_neg) = res[:, 2:].T
    if offset is not None:
        offx, offy = offset
        y -= offy
        x -= offx
    if debug:
        for i in range(n_frames):
            print("\nShifts in X and Y")
            print(x[i], y[i])
    array_rec = cube_shift(cube, y, x, imlib=imlib,
                           interpolation=interpolation,
                           border_mode=border_mode)
    if verbose:
        timing(start_time)
    if plot:
        extra = None
        if two_neg:
            extra = [(cx - x_neg, "shifts X (neg gaussian)"),
                     (cy - y_neg, "shifts Y (neg gaussian)")]
        _plot_shifts(x, y, extra=extra)
    if save_shifts:
        np.savetxt("recent_gauss_shifts.txt", np.transpose([y, x]),
                   fmt="%f")
    if full_output:
        if two_neg:
            return (array_rec, y, x, y_neg, x_neg, fwhm_x, fwhm_y,
                    fwhm_neg_x, fwhm_neg_y, theta, theta_neg, amp_pos,
                    amp_neg)
        return array_rec, y, x
    return array_rec


# ----------------------------------------------------------------------
# speckle cross-correlation


def _annulus_flux_grid(frame, grid_sh_x, grid_sh_y, rads, ann_sz):
    """vip_tpu's loops of ``_fit_2dannulus`` (recentering.py:860-871):
    for every (x, y) of the grid, the frame shifted by (y, x) and, over
    ``rads`` in order, the largest annulus mean above 0 and its radius.
    All the shifts at once (``_shift_copies``), each radius one masked
    mean. Returns host (len(x), len(y)) flux and radius arrays."""
    from ..var.shapes import get_annulus_segments

    gy, gx = np.meshgrid(grid_sh_y, grid_sh_x)         # [ii (x), jj (y)]
    shifted = _shift_copies(frame, gy.ravel(), gx.ravel())
    flux = torch.zeros(shifted.shape[0], dtype=shifted.dtype,
                       device=shifted.device)
    best = torch.zeros_like(flux)
    for rad in rads:
        yy, xx = get_annulus_segments(tuple(frame.shape), rad, ann_sz)[0]
        mean = shifted[:, torch.as_tensor(yy, device=frame.device),
                       torch.as_tensor(xx, device=frame.device)].mean(dim=-1)
        better = mean > flux
        flux = torch.where(better, mean, flux)
        best = torch.where(better, float(rad), best)
    shape = (len(grid_sh_x), len(grid_sh_y))
    return _host(flux).reshape(shape), _host(best).reshape(shape)


def _fit_2dannulus(array, fwhm=4, crop=False, cent=None, cropsize=15,
                   ann_rad=0.5, ann_width=0.5, sampl_cen=0.1, sampl_rad=None,
                   unc_in=2.):
    """Donut-PSF center from an annulus-flux grid search (vip_tpu
    recentering.py:827), the whole grid shifted at once."""
    from ..var.shapes import get_square

    array = as_tensor(array)
    if cent is None:
        ceny, cenx = frame_center(array)
    else:
        cenx, ceny = cent
    if crop:
        x_sub_px = cenx % 1
        y_sub_px = ceny % 1
        imside = array.shape[0]
        psf_subimage, suby, subx = get_square(array, min(cropsize, imside),
                                              int(ceny), int(cenx),
                                              position=True)
        ceny, cenx = frame_center(psf_subimage)
        ceny += y_sub_px
        cenx += x_sub_px
        array = psf_subimage

    ann_sz = ann_width * fwhm
    grid_sh_x = np.arange(-unc_in, unc_in, sampl_cen)
    grid_sh_y = np.arange(-unc_in, unc_in, sampl_cen)
    if sampl_rad is None:
        rads = [ann_rad * fwhm]
    else:
        rads = np.arange(0.5 * ann_rad * fwhm, 2 * ann_rad * fwhm,
                         sampl_rad)
    flux_ann, best_rad = _annulus_flux_grid(array, grid_sh_x, grid_sh_y,
                                            rads, ann_sz)
    i_max, j_max = np.unravel_index(np.argmax(flux_ann), flux_ann.shape)
    mean_x = cenx - grid_sh_x[i_max]
    mean_y = ceny - grid_sh_y[j_max]
    if sampl_rad is None:
        return mean_y, mean_x, ann_rad * fwhm
    return mean_y, mean_x, best_rad[i_max, j_max] / fwhm


def cube_recenter_via_speckles(cube_sci, cube_ref=None, alignment_iter=5,
                               gammaval=1, min_spat_freq=0.5,
                               max_spat_freq=3, fwhm=4, upsample_factor=100,
                               debug=False, recenter_median=False,
                               fit_type="gaus", negative=True, crop=True,
                               subframesize=25, mask=None, ann_rad=0.5,
                               ann_rad_search=False, ann_width=0.5,
                               collapse="median", imlib="vip-fft",
                               interpolation="lanczos4",
                               border_mode="reflect", log=True, plot=True,
                               full_output=False, nproc=1, **collapse_args):
    """Recenter a cube by cross-correlating its speckle pattern (vip_tpu
    recentering.py:880): every iteration collapses the aligned cube (the
    median through CUDA kernel H1 on the card), registers every frame to
    it in one batched DFT registration, and shifts them all in one
    ``cube_shift``. Returns the recentered cube (and reference cube), and
    with ``full_output`` the filtered and stretched cubes and the
    cumulated shifts."""
    from ..var.filters import cube_filter_highpass, cube_filter_lowpass
    from ..var.shapes import get_square
    from .cosmetics import cube_crop_frames, frame_crop
    from .subsampling import cube_collapse

    check_array(cube_sci, dim=3)
    cube_sci = as_tensor(cube_sci)
    n, y, x = cube_sci.shape
    gam = gammaval

    if recenter_median and fit_type not in {"gaus", "ann"}:
        raise TypeError("fit type not recognized. Should be 'ann' or "
                        "'gaus'")
    if crop and not subframesize < y:
        raise ValueError("`Subframesize` is too large")

    ref_star = cube_ref is not None
    if ref_star:
        cube_ref = as_tensor(cube_ref, cube_sci.device)
        nref = cube_ref.shape[0]

    if crop:
        cube_sci_subframe = cube_crop_frames(cube_sci, subframesize,
                                             force=True, verbose=False)
        if ref_star:
            cube_ref_subframe = cube_crop_frames(cube_ref, subframesize,
                                                 force=True, verbose=False)
    else:
        subframesize = cube_sci.shape[-1]
        cube_sci_subframe = cube_sci
        if ref_star:
            cube_ref_subframe = cube_ref

    ceny, cenx = frame_center(cube_sci_subframe[0])
    print("Sub frame shape: {}".format(tuple(cube_sci_subframe.shape)))
    print("Center pixel: ({}, {})".format(ceny, cenx))

    def _filtered(sub):
        lpf = sub - sub.min()
        median_size = int(fwhm * max_spat_freq)
        hpf = cube_filter_highpass(lpf, "median-subt",
                                   median_size=median_size, verbose=False) \
            if max_spat_freq > 0 else lpf
        if min_spat_freq > 0:
            return cube_filter_lowpass(hpf, "gauss",
                                       fwhm_size=min_spat_freq * fwhm,
                                       verbose=False)
        return hpf.clone()

    cube_sci_lpf = _filtered(cube_sci_subframe)
    parts = [cube_sci_lpf]
    if ref_star:
        parts.append(_filtered(cube_ref_subframe))
    align_cube = torch.cat([cube_sci_lpf.new_zeros(
        (1, subframesize, subframesize))] + parts)
    n_frames = align_cube.shape[0]
    cum_y_shifts = 0
    cum_x_shifts = 0
    cube_stret = None

    def _recenter_median_frame(frame0):
        from ..var.fit_2d import _gaussian_fit

        if fit_type == "gaus" and negative:
            crop_sz = int(fwhm)
        elif fit_type == "gaus":
            crop_sz = int(3 * fwhm)
        else:
            crop_sz = int(6 * fwhm)
        if not crop_sz % 2:
            if crop_sz > 7:
                crop_sz -= 1
            else:
                crop_sz += 1
        sub_image, y1, x1 = get_square(frame0, size=crop_sz, y=ceny, x=cenx,
                                       position=True)
        if fit_type == "gaus":
            sub_image = _host(sub_image)
            if negative:
                sub_image = -sub_image + np.abs(np.min(-sub_image))
            res = _gaussian_fit(sub_image, crop=False, threshold=False,
                                sigfactor=1, debug=debug)
            y_i, x_i = res["centroid_y"], res["centroid_x"]
        else:
            sampl_cen = 1. / upsample_factor
            sampl_rad = fwhm * ann_rad / 10 if ann_rad_search else None
            y_i, x_i, _ = _fit_2dannulus(sub_image, fwhm=fwhm, crop=False,
                                         ann_rad=ann_rad,
                                         sampl_cen=sampl_cen,
                                         sampl_rad=sampl_rad,
                                         ann_width=ann_width, unc_in=2.)
        return ceny - (y1 + y_i), cenx - (x1 + x_i)

    for it in range(alignment_iter):
        align_cube[0] = cube_collapse(align_cube[1:(n + 1)], mode=collapse,
                                      **collapse_args)
        if recenter_median:
            yshift, xshift = _recenter_median_frame(align_cube[0])
            align_cube[0] = frame_shift(align_cube[0], yshift, xshift,
                                        imlib=imlib,
                                        interpolation=interpolation,
                                        border_mode=border_mode)
        if log:
            cube_stret = torch.log10((align_cube - align_cube.min() + 1)
                                     ** gam)
        else:
            cube_stret = align_cube.clone()
        if mask is not None and crop:
            mask_tmp = frame_crop(mask, subframesize)
        else:
            mask_tmp = mask
        res = cube_recenter_dft_upsampling(
            cube_stret, center_fr1=(ceny, cenx),
            upsample_factor=upsample_factor, fwhm=fwhm, subi_size=None,
            full_output=True, verbose=False, plot=False, mask=mask_tmp,
            imlib=imlib, interpolation=interpolation, nproc=nproc)
        cube_stret, y_shift, x_shift = res
        sqsum_shifts = np.sum(np.sqrt(y_shift ** 2 + x_shift ** 2))
        print("Square sum of shift vecs: " + str(sqsum_shifts))
        align_cube[1:] = cube_shift(align_cube[1:], y_shift[1:],
                                    x_shift[1:], imlib=imlib,
                                    interpolation=interpolation,
                                    border_mode=border_mode)
        cum_y_shifts += y_shift
        cum_x_shifts += x_shift

    cum_y_shifts_sci = cum_y_shifts[1:(n + 1)]
    cum_x_shifts_sci = cum_x_shifts[1:(n + 1)]
    cube_reg_sci = cube_shift(cube_sci, cum_y_shifts_sci, cum_x_shifts_sci,
                              imlib=imlib, interpolation=interpolation,
                              border_mode=border_mode)
    if plot:
        _plot_shifts(cum_x_shifts_sci, cum_y_shifts_sci)
    if ref_star:
        cum_y_shifts_ref = cum_y_shifts[(n + 1):]
        cum_x_shifts_ref = cum_x_shifts[(n + 1):]
        cube_reg_ref = cube_shift(cube_ref, cum_y_shifts_ref,
                                  cum_x_shifts_ref, imlib=imlib,
                                  interpolation=interpolation,
                                  border_mode=border_mode)
        if full_output:
            return (cube_reg_sci, cube_reg_ref, cube_sci_lpf, cube_stret,
                    cum_x_shifts_sci, cum_y_shifts_sci, cum_x_shifts_ref,
                    cum_y_shifts_ref)
        return cube_reg_sci, cube_reg_ref
    if full_output:
        return (cube_reg_sci, cube_sci_lpf, cube_stret, cum_x_shifts_sci,
                cum_y_shifts_sci)
    return cube_reg_sci

"""NEGFC forward model and batched walker log-probability (port of
``vip_tpu.ops.negfc_model``).

vip_tpu writes one walker's likelihood as a jitted XLA function of traced
(r, θ, f) and vmaps it over the walkers. The port computes a batch of W
walkers directly on tensors, on the cube's device:

1. on the host, in float64: each walker's bounds check (a walker out of
   bounds gets -inf and is not evaluated), the per-frame integer
   placement and sub-pixel shift of the PSF stamp, and the flux with the
   transmission and the frame weights; one copy to the device;
2. the cyclic sub-pixel shift of the stamp for every (walker, frame)
   pair in one batched FFT (``ops.fft.cyclic_fourier_shift``, scipy's
   'ndimage-fourier');
3. the placement as one indexed subtract into each walker's copy of the
   annulus matrix (the cube's annulus pixels, gathered once): stamp
   pixels off the annulus are dropped, which is the injection into the
   frame followed by the annulus gather;
4. the matrix scaling and the top-``ncomp`` SVD of each walker's (n, p)
   matrix in one batched ``ops.linalg.svd_top`` (cuSOLVER's ``gesvd`` on
   the card, F2), or the static basis of a ``cube_ref`` library;
5. project and subtract;
6. the residuals scattered into zero frames and derotated by
   ``ops.shear.rotate_exact`` (CUDA kernel H2 on a float32 card cube), in
   chunks of frames of all walkers under the 8 GiB working set of
   ``preproc.derotation._auto_chunk`` (and the walkers themselves in
   passes under the same budget);
7. of each derotated frame only the aperture pixels are kept (those
   inside the annulus r_guess -+ annulus_width / 2, as the host
   ``fm.get_values_optimize`` keeps them), and the frames are collapsed
   there: the median by ``preproc.subsampling.
   collapse_jax`` (CUDA kernel H1 on the card, one launch for the batch),
   which is the per-pixel median of the full frames read at the aperture;
8. the log-likelihood of each walker.

A 4-d (channels, frames, y, x) cube runs steps 1-7 channel by channel,
each with its own PSF, library basis and transmission, a scalar flux
shared by the channels or one flux a channel, and the channels' aperture
values collapse with ``collapse_ifs`` before the likelihood (vip_tpu's
``is4d`` branch).

``run_stretch_mcmc`` is the affine-invariant stretch move around such a
batch. Its random draws come from a ``torch.Generator`` or from a
callable ``draws(step, half, ns0, n1) -> (u_z, partners, u_accept)``,
``step`` counting sweeps from 0, ``half`` 0 or 1 for the first or second
half-update, ``ns0`` the size of the half-ensemble being moved and ``n1``
that of the other half: a test feeds vip_tpu's threefry draws through it.
"""

import numpy as np
import torch

from ..config.device import as_tensor
from ..preproc import subsampling
from ..preproc.derotation import _auto_chunk
from ..var.coords import frame_center
from ..var.shapes import disk_coords, get_annulus_segments
from .fft import cyclic_fourier_shift
from .linalg import matrix_scaling_jax, svd_top
from .shear import rotate_exact

__all__ = ["make_negfc_lnprob", "make_batched_lnprob", "cyclic_fourier_shift",
           "run_stretch_mcmc"]

#: Working set of the walkers of one pass (bytes): the budget of
#: ``preproc.derotation._auto_chunk``
_WORKING_SET = 8 << 30


def _stamp_origin(ny, nx, size_fc):
    """Frame row and column of the stamp's corner for a companion at the
    frame center (vip_tpu negfc_model.py:50-56)."""
    cy, cx = frame_center((ny, nx))
    w = int(np.ceil(size_fc / 2))
    if size_fc % 2:
        w -= 1
    return cy - w, cx - w


def _shift_parts(r, theta, angs):
    """Host float64 (W, n) integer and sub-pixel parts of the shift of a
    companion at (r, theta) in frames at parallactic angles ``angs``:
    the integer part truncated toward zero, as the injector does."""
    ang = np.deg2rad(np.asarray(theta, float))[:, None]
    a = np.deg2rad(np.asarray(angs, float))[None, :]
    r = np.asarray(r, float)[:, None]
    shift_y = r * np.sin(ang - a)
    shift_x = r * np.cos(ang - a)
    int_y = shift_y.astype(int)
    int_x = shift_x.astype(int)
    return int_y, int_x, shift_y - int_y, shift_x - int_x


def _place(target, col_map, stamps, y0, x0, scale, ny, nx):
    """Subtract ``scale[b]`` x ``stamps[b]`` with its corner at frame
    pixel (y0[b], x0[b]) from row b of ``target`` (B, m), in one indexed
    add: stamp pixel (y, x) lands in column ``col_map[y * nx + x]``;
    pixels off the frame or whose ``col_map`` entry is -1 are dropped (they
    add 0 to the row's first column instead, so that nothing syncs)."""
    B, s = stamps.shape[0], stamps.shape[-1]
    m = target.shape[-1]
    q = torch.arange(s, device=target.device)
    ys = y0[:, None] + q
    xs = x0[:, None] + q
    inside = ((ys >= 0) & (ys < ny))[:, :, None] \
        & ((xs >= 0) & (xs < nx))[:, None, :]
    flat = ys.clamp(0, ny - 1)[:, :, None] * nx \
        + xs.clamp(0, nx - 1)[:, None, :]
    cols = col_map[flat]
    keep = inside & (cols >= 0)
    rows = (torch.arange(B, device=target.device) * m)[:, None, None]
    idx = torch.where(keep, rows + cols, rows)
    vals = torch.where(keep, -(scale[:, None, None] * stamps), 0.0)
    target.view(-1).index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return target


def _inject_negfc(cube, psfn, angs, r, theta, flux):
    """``cube`` (n, ny, nx) minus ``flux`` (a scalar or one value a frame)
    times the PSF ``psfn`` shifted to (r, theta) in each frame, on the
    cube's device: the 'ndimage-fourier' injection of
    ``fm.cube_inject_companions`` with the negative flux (vip_tpu
    fakecomp.py:35; the stamp clipped at the frame edge). Returns a new
    tensor."""
    cube = as_tensor(cube)
    n, ny, nx = cube.shape
    dev, dt = cube.device, cube.dtype
    psfn = as_tensor(psfn, dev, dt)
    int_y, int_x, dsy, dsx = _shift_parts([r], [theta], angs)
    sty, stx = _stamp_origin(ny, nx, psfn.shape[-1])
    geo = torch.as_tensor(np.stack([int_y[0] + sty, int_x[0] + stx, dsy[0],
                                    dsx[0], np.broadcast_to(
                                        np.asarray(flux, float), (n,))]),
                          dtype=torch.float64).to(dev)
    stamps = cyclic_fourier_shift(psfn, geo[2], geo[3])
    col_map = torch.arange(ny * nx, device=dev)
    out = cube.clone().reshape(n, ny * nx)
    _place(out, col_map, stamps, geo[0].long(), geo[1].long(),
           geo[4].to(dt), ny, nx)
    return out.view(n, ny, nx)


def make_negfc_lnprob(cube, angs, psfn, ncomp, annulus_width, r_guess,
                      theta_guess, aperture_radius, fwhm, mu, sigma2_spe,
                      bounds, svd_method="lapack", collapse="median",
                      sigma="spe+pho", force_rPA=False, weights=None,
                      transmission=None, cube_ref=None, scaling=None,
                      collapse_ifs="absmean", mu_sigma_is_tuple=True,
                      fmerit="sum"):
    """The NEGFC log-probability (vip_tpu negfc_model.py:97, same
    parameters): ``lnprob(params)`` with params a (W, ndim) batch of
    walkers (an array or tensor) of (r, theta, f), or the fluxes alone
    with ``force_rPA``, returns a (W,) tensor on the cube's device (numpy
    cubes go to the default device); one walker's (ndim,) params give a
    0-d tensor. The annulus and aperture geometry is static,
    from (r_guess, theta_guess), as the reference's lnlike
    (vip_hci/fm/negfc_mcmc.py:123-343). Covers per-frame ``weights``,
    radial coronagraph ``transmission``, a ``cube_ref`` library (its
    principal components static), the four ``scaling`` modes, the
    collapses 'median', 'mean' and 'sum', and the (mu, sigma) and
    'sum'/'stddev' merits. A 4-d cube takes a (channels, y, x) ``psfn``,
    params (r, theta, f) or (r, theta, f_1..f_z), and ``collapse_ifs``
    'mean', 'median', 'sum' or 'absmean' over the channels."""
    cube = as_tensor(cube)
    if cube.ndim not in (3, 4):
        raise TypeError("`cube` must be a 3d or 4d array")
    is4d = cube.ndim == 4
    if collapse not in ("median", "mean", "sum"):
        raise ValueError("collapse not supported in device model")
    if is4d and collapse_ifs not in ("mean", "median", "sum", "absmean"):
        raise ValueError("collapse_ifs not supported in device model")
    if not mu_sigma_is_tuple and fmerit not in ("sum", "stddev"):
        raise ValueError("fmerit choice not recognized.")
    nch = cube.shape[0] if is4d else 1
    n, ny, nx = cube.shape[-3:]
    dev, dt = cube.device, cube.dtype
    psfn = as_tensor(psfn, dev, dt)
    if not is4d:
        psfn = psfn[None]
    angs = np.asarray(angs.cpu() if isinstance(angs, torch.Tensor) else angs,
                      dtype=float)

    # static geometry: pca_annulus's annulus of integer radii, and the
    # aperture pixels inside the annulus r_guess -+ annulus_width / 2, as
    # get_values_optimize keeps them (vip_tpu's model keeps those inside
    # the integer annulus instead, which differs for a fractional r_guess:
    # ROADMAP.md Queue 3)
    inrad = int(r_guess - annulus_width / 2.0)
    outrad = int(r_guess + annulus_width / 2.0)
    ann_yy, ann_xx = get_annulus_segments((ny, nx), inrad,
                                          int(round(outrad - inrad)),
                                          nsegm=1)[0]
    ceny, cenx = frame_center((ny, nx))
    posy = r_guess * np.sin(np.deg2rad(theta_guess)) + ceny
    posx = r_guess * np.cos(np.deg2rad(theta_guess)) + cenx
    ap_yy, ap_xx = disk_coords((posy, posx), aperture_radius * fwhm,
                               (ny, nx))
    ring = get_annulus_segments((ny, nx), r_guess - annulus_width / 2,
                                annulus_width, nsegm=1)[0]
    ring = set(zip(ring[0].tolist(), ring[1].tolist()))
    keep = [i for i, p in enumerate(zip(ap_yy.tolist(), ap_xx.tolist()))
            if p in ring]
    ann_flat = torch.as_tensor(ann_yy * nx + ann_xx, device=dev)
    ap_flat = torch.as_tensor((ap_yy * nx + ap_xx)[keep], device=dev)
    p = ann_flat.numel()
    col_map = torch.full((ny * nx,), -1, dtype=torch.long, device=dev)
    col_map[ann_flat] = torch.arange(p, device=dev)
    base = cube.reshape(nch, n, ny * nx)[:, :, ann_flat]
    sty, stx = _stamp_origin(ny, nx, psfn.shape[-1])
    size_fc = psfn.shape[-1]

    lo = np.array([b[0] for b in bounds], float)
    hi = np.array([b[1] for b in bounds], float)
    ncomp = int(ncomp)
    w_fr = None if weights is None else np.asarray(weights, float)
    tabs = None
    if transmission is not None:
        # the tables the injector pads, one a channel (vip_tpu
        # negfc_model.py:78, :161-168)
        from ..fm.fakecomp import _extend_transmission

        transmission = np.asarray(transmission, dtype=float)
        tabs = [_extend_transmission(np.array(
            [transmission[0], transmission[1 if transmission.shape[0] == 2
                                           else ch + 1]]), nx)
            for ch in range(nch)]
    V_static = None
    if cube_ref is not None:
        if not is4d:
            refs = [cube_ref]
        elif isinstance(cube_ref, (list, tuple)):
            refs = list(cube_ref)
        elif cube_ref.ndim == 3:
            refs = [cube_ref] * nch
        else:
            refs = [cube_ref[ch] for ch in range(nch)]
        V_static = []
        for rc in refs:
            ref = as_tensor(rc, dev, dt)
            V_static.append(svd_top(matrix_scaling_jax(
                ref.reshape(ref.shape[0], -1)[:, ann_flat], scaling), ncomp,
                method=svd_method))
    neg_angs = torch.as_tensor(-angs, dtype=dt, device=dev)
    # walkers a pass: each holds its (n, p) matrix, the SVD's factor of the
    # same size, the scaled copy and the residuals
    per_walker = 4 * n * max(n, p) * cube.element_size()
    walker_chunk = max(1, _WORKING_SET // per_walker)
    mu = torch.as_tensor(mu, dtype=dt, device=dev)
    sigma2_spe = torch.as_tensor(sigma2_spe, dtype=dt, device=dev)

    def values(r, theta, f):
        """Aperture values of the collapsed residual frames, (Wv, n_ap),
        for (Wv,) radii and angles and (Wv, nch) fluxes."""
        per_ch = [channel_values(ch, r, theta, f[:, ch])
                  for ch in range(nch)]
        if not is4d:
            return per_ch[0]
        stack = torch.stack(per_ch)
        if collapse_ifs == "absmean":
            return stack.abs().mean(dim=0)
        return subsampling.collapse_jax(stack, collapse_ifs)

    def channel_values(ch, r, theta, f):
        Wv = len(r)
        if tabs is not None:
            f = f * np.interp(r, tabs[ch][0], tabs[ch][1])
        flux = f[:, None] * (w_fr[None, :] if w_fr is not None
                             else np.ones((1, n)))
        int_y, int_x, dsy, dsx = _shift_parts(r, theta, angs)
        # the stamp's corner clamped into the frame, as the reference
        # model's dynamic_update_slice clamps it
        y0 = np.clip(sty + int_y, 0, ny - size_fc)
        x0 = np.clip(stx + int_x, 0, nx - size_fc)
        geo = torch.as_tensor(np.stack([y0, x0, dsy, dsx, flux]),
                              dtype=torch.float64).to(dev)
        geo = geo.reshape(5, Wv * n)
        stamps = cyclic_fourier_shift(psfn[ch], geo[2], geo[3])
        data = base[ch].repeat(Wv, 1)
        _place(data, col_map, stamps, geo[0].long(), geo[1].long(),
               geo[4].to(dt), ny, nx)
        data = matrix_scaling_jax(data.view(Wv, n, p), scaling)
        V = V_static[ch] if V_static is not None \
            else svd_top(data, ncomp, method=svd_method)
        residuals = (data - (data @ V.mT) @ V).reshape(Wv * n, p)
        del data

        vals = torch.empty((Wv * n, ap_flat.numel()), dtype=dt, device=dev)
        chunk = _auto_chunk(Wv * n, ny, cube.element_size())
        frames = torch.zeros((min(chunk, Wv * n), ny * nx), dtype=dt,
                             device=dev)
        for s in range(0, Wv * n, chunk):
            e = min(s + chunk, Wv * n)
            fr = frames[:e - s]
            fr.zero_()
            fr[:, ann_flat] = residuals[s:e]
            idx = torch.arange(s, e, device=dev) % n
            der = rotate_exact(fr.view(e - s, ny, nx), neg_angs[idx])
            vals[s:e] = der.reshape(e - s, ny * nx)[:, ap_flat]
        vals = vals.view(Wv, n, -1).transpose(0, 1).contiguous()
        return subsampling.collapse_jax(vals, collapse)

    def lnprob(params):
        if isinstance(params, torch.Tensor):
            params = params.detach().cpu().numpy()
        params = np.asarray(params, dtype=float)
        if params.ndim == 1:
            return lnprob(params[None])[0]
        W = params.shape[0]
        out = torch.full((W,), -np.inf, dtype=dt, device=dev)
        inb = np.nonzero(np.all((params >= lo) & (params <= hi), axis=1))[0]
        if inb.size == 0:
            return out
        # uploaded before the batch's work is queued: a copy from pageable
        # memory waits for the stream
        inb_t = torch.as_tensor(inb, device=dev)
        pv = params[inb]
        if force_rPA:
            r = np.full(len(inb), float(r_guess))
            theta = np.full(len(inb), float(theta_guess))
            f = pv
        else:
            r, theta, f = pv[:, 0], pv[:, 1], pv[:, 2:]
        # one flux shared by the channels, or one a channel
        f = np.broadcast_to(f[:, :1], (len(inb), nch)) if f.shape[1] == 1 \
            else f[:, :nch]
        v = torch.cat([values(r[i:i + walker_chunk],
                              theta[i:i + walker_chunk],
                              f[i:i + walker_chunk])
                       for i in range(0, len(r), walker_chunk)])
        if mu_sigma_is_tuple:
            num = (mu - v) ** 2
            denom = torch.zeros_like(v)
            if "spe" in sigma:
                denom = denom + sigma2_spe
            if "pho" in sigma:
                denom = denom + torch.abs(v - mu)
            ll = -0.5 * torch.sum(num / denom, dim=-1)
        elif fmerit == "sum":
            ll = -0.5 * torch.sum(torch.abs(v - mu), dim=-1)
        else:
            # the reference: -np.std(values[values != 0], ddof=1) * size
            nz = v != 0
            k = nz.sum(dim=-1)
            mean_nz = torch.where(nz, v, 0.0).sum(dim=-1) / k.clamp(min=1)
            var = torch.where(nz, (v - mean_nz[:, None]) ** 2, 0.0).sum(
                dim=-1) / (k - 1).clamp(min=1)
            ll = -torch.sqrt(var) * v.shape[-1]
        out[inb_t] = ll
        return out

    return lnprob


def make_batched_lnprob(*args, **kwargs):
    """The log-probability of a (W, ndim) batch of walkers (vip_tpu
    negfc_model.py:277): :func:`make_negfc_lnprob`, which takes batches."""
    return make_negfc_lnprob(*args, **kwargs)


def _generator_draws(generator):
    """A ``draws`` callable (see the module docstring) drawing from a
    ``torch.Generator`` on the host: z's uniform, the partners, then the
    acceptance uniform, each half-update."""
    def draws(step, half, ns0, n1):
        u_z = torch.rand(ns0, generator=generator, dtype=torch.float64)
        partners = torch.randint(0, n1, (ns0,), generator=generator)
        u_acc = torch.rand(ns0, generator=generator, dtype=torch.float64)
        return u_z.numpy(), partners.numpy(), u_acc.numpy()
    return draws


def _draws_of(key):
    """The ``draws`` callable of ``key``: itself, or drawn from a
    ``torch.Generator``."""
    if isinstance(key, torch.Generator):
        return _generator_draws(key)
    if callable(key):
        return key
    raise TypeError("key must be a torch.Generator or a draws(step, half, "
                    "ns0, n1) callable")


def _stretch_sweep(coords, lp, lnprob_batched, draws, step, a):
    """One sweep of the stretch move (Goodman & Weare, emcee's
    ``StretchMove``) over the host (W, ndim) ``coords`` with log-probs
    ``lp``, both updated in place: two half-updates, each one batch of
    proposals to ``lnprob_batched`` and one read of its values. Returns
    the (W,) accepted flags."""
    nwalkers, ndim = coords.shape
    half = nwalkers // 2
    accepted = np.zeros(nwalkers, dtype=bool)
    for h, ((i0, i1), (j0, j1)) in enumerate((((0, half), (half, nwalkers)),
                                              ((half, nwalkers), (0, half)))):
        S0 = coords[i0:i1]
        S1 = coords[j0:j1]
        ns0 = S0.shape[0]
        u, partners, u_acc = draws(step, h, ns0, S1.shape[0])
        z = ((a - 1.0) * np.asarray(u, float) + 1.0) ** 2 / a
        partners = np.asarray(partners)
        proposal = S1[partners] + z[:, None] * (S0 - S1[partners])
        lp_new = lnprob_batched(proposal)
        if isinstance(lp_new, torch.Tensor):
            lp_new = lp_new.cpu().numpy()
        lp_new = np.asarray(lp_new, dtype=float)
        log_ratio = (ndim - 1) * np.log(z) + lp_new - lp[i0:i1]
        accept = np.log(np.asarray(u_acc, float)) < log_ratio
        coords[i0:i1][accept] = proposal[accept]
        lp[i0:i1][accept] = lp_new[accept]
        accepted[i0:i1] = accept
    return accepted


def run_stretch_mcmc(lnprob_batched, pos0, n_iterations, key, a=2.0,
                     callback=None, callback_every=None):
    """Affine-invariant ensemble MCMC (the stretch move, emcee's) with
    each half-ensemble's likelihoods as one batch (vip_tpu
    negfc_model.py:283).

    ``lnprob_batched``: (W, ndim) -> (W,) array or tensor. ``key``: a
    ``torch.Generator`` or a ``draws`` callable (module docstring).
    ``callback(k, chain, acc)``: called every ``callback_every`` sweeps;
    a true return stops the run. Returns (chain (nwalkers, steps, ndim),
    lnprobs (nwalkers, steps), acceptance rate)."""
    draws = _draws_of(key)
    coords = np.array(pos0.cpu() if isinstance(pos0, torch.Tensor) else pos0,
                      dtype=float)
    nwalkers, ndim = coords.shape
    lp = lnprob_batched(coords)
    lp = np.array(lp.cpu() if isinstance(lp, torch.Tensor) else lp,
                  dtype=float)
    chain = np.empty((nwalkers, n_iterations, ndim))
    lnps = np.empty((nwalkers, n_iterations))
    n_accept = 0
    for k in range(n_iterations):
        n_accept += int(_stretch_sweep(coords, lp, lnprob_batched, draws, k,
                                       a).sum())
        chain[:, k] = coords
        lnps[:, k] = lp
        if callback is not None and callback_every and \
                (k + 1) % callback_every == 0:
            if callback(k, chain[:, :k + 1], None):
                return (chain[:, :k + 1], lnps[:, :k + 1],
                        n_accept / ((k + 1) * nwalkers))
    return chain, lnps, n_accept / (n_iterations * nwalkers)

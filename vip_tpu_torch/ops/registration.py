"""Sub-pixel image registration (port of ``vip_tpu.ops.registration``).

Guizar-Sicairos matrix-multiply DFT upsampling ([GUI08], the algorithm of
skimage's ``phase_cross_correlation``), batched over frames on their
device: one ``torch.fft.fft2`` of the frames, one argmax a frame, and the
two upsampled-DFT products as batched complex ``torch.matmul`` with
per-frame offset kernels (vip_tpu builds them with ``tensordot``, outside
any Pallas kernel). The masked variant (Padfield 2012) runs a batch of
moving frames against one reference in the same way.

An argmax tie takes the first flat index (as ``jnp.argmax``), and
``torch.round`` rounds half to even (as ``jnp.round``). The kernels'
phases are evaluated in float64 and cast to the working complex dtype.
"""

import math

import numpy as np
import torch

from ..config.device import as_tensor

__all__ = ["dft_registration", "dft_registration_batch", "upsampled_dft",
           "masked_register_translation"]

# the complex arrays of one registration chunk, under the port's 8 GiB
# budget (preproc/derotation.py:122)
_CHUNK_BYTES = 8 << 30

# vip_tpu takes ``jnp.finfo(float).eps``, float64's, whatever the dtype
_EPS = float(np.finfo(float).eps)


def _complex(real_dtype):
    return torch.complex128 if real_dtype == torch.float64 \
        else torch.complex64


def _offset_kernel(n_items, urs, u, offsets, cdtype):
    """(B, urs, n_items) kernels exp(-2πi (arange(urs) - offset) ·
    fftfreq(n_items, u)) of a batch of per-frame offsets, the phase in
    float64."""
    dev = offsets.device
    freq = torch.fft.fftfreq(n_items, d=u, dtype=torch.float64, device=dev)
    rows = torch.arange(urs, dtype=torch.float64, device=dev)
    arg = (rows[None, :] - offsets.to(torch.float64)[:, None])[..., None] \
        * freq[None, None, :]
    return torch.polar(torch.ones_like(arg), -2 * math.pi * arg).to(cdtype)


def upsampled_dft(data, upsampled_region_size, upsample_factor,
                  axis_offsets):
    """Upsampled DFT of a complex frame, or of each frame of a (B, ny, nx)
    batch, over a small region, by matrix products (vip_tpu
    registration.py:19). ``axis_offsets`` is the (y, x) offset, or one a
    frame as a (B, 2) tensor. The last axis is contracted first, as
    skimage does."""
    single = data.ndim == 2
    if single:
        data = data[None]
    B, ny, nx = data.shape
    off = torch.as_tensor(axis_offsets, dtype=torch.float64,
                          device=data.device).reshape(-1, 2).expand(B, 2)
    urs = int(upsampled_region_size)
    kx = _offset_kernel(nx, urs, float(upsample_factor), off[:, 1],
                        data.dtype)
    ky = _offset_kernel(ny, urs, float(upsample_factor), off[:, 0],
                        data.dtype)
    out = torch.matmul(ky, torch.matmul(data, kx.transpose(-1, -2)))
    return out[0] if single else out


def _unravel(flat, ncols):
    return torch.stack([torch.div(flat, ncols, rounding_mode="floor"),
                        flat % ncols], dim=-1)


def _register(ref_freq, freqs, upsample_factor):
    """Shifts (B, 2) that register the frames of spectra ``freqs`` onto the
    reference spectrum (vip_tpu registration.py:36)."""
    B, ny, nx = freqs.shape
    real = torch.float64 if freqs.dtype == torch.complex128 \
        else torch.float32
    image_product = ref_freq * torch.conj(freqs)
    cc = torch.fft.ifft2(image_product)
    amax = torch.argmax(torch.abs(cc).reshape(B, -1), dim=1)
    del cc
    maxima = _unravel(amax, nx).to(real)
    shape = torch.tensor([ny, nx], dtype=real, device=freqs.device)
    midpoints = torch.trunc(shape / 2)
    shifts = torch.where(maxima > midpoints, maxima - shape, maxima)
    if upsample_factor > 1:
        u = float(upsample_factor)
        urs = int(math.ceil(u * 1.5))
        dftshift = math.trunc(urs / 2.0)
        shifts = torch.round(shifts * u) / u
        sample_region_offset = dftshift - shifts * u
        data = torch.conj(upsampled_dft(torch.conj(image_product), urs, u,
                                        sample_region_offset))
        amax2 = torch.argmax(torch.abs(data).reshape(B, -1), dim=1)
        maxima2 = _unravel(amax2, urs).to(real) - dftshift
        shifts = shifts + maxima2 / u
    return shifts


def dft_registration(ref_freq, target_freq, upsample_factor=1):
    """Shift (dy, dx) that registers ``target`` to ``ref`` given their
    FFTs (vip_tpu registration.py:36): the coarse pixel peak of the
    cross-correlation, refined on a 1.5·``upsample_factor`` grid around
    it. Returns a (2,) tensor on the spectra's device."""
    ref_freq = as_tensor(ref_freq)
    target_freq = as_tensor(target_freq, ref_freq.device)
    return _register(ref_freq, target_freq[None], int(upsample_factor))[0]


def _frames_per_chunk(n_arrays, shape, cdtype):
    """Frames of a chunk that holds ``n_arrays`` complex arrays of
    ``shape`` a frame within ``_CHUNK_BYTES``."""
    per_frame = n_arrays * int(np.prod(shape)) * torch.empty(
        (), dtype=cdtype).element_size()
    return max(1, _CHUNK_BYTES // per_frame)


def dft_registration_batch(ref, cube, upsample_factor=1):
    """Register every frame of ``cube`` to ``ref`` (vip_tpu
    registration.py:70): the frames' spectra in one ``fft2`` a chunk, one
    argmax and one pair of upsampled-DFT products a frame, batched.
    Returns (n, 2) shifts as a tensor on the cube's device."""
    cube = as_tensor(cube)
    ref = as_tensor(ref, cube.device, cube.dtype)
    ref_freq = torch.fft.fft2(ref)
    chunk = _frames_per_chunk(3, cube.shape[1:], ref_freq.dtype)
    out = [_register(ref_freq, torch.fft.fft2(cube[s:s + chunk]),
                     int(upsample_factor))
           for s in range(0, cube.shape[0], chunk)]
    if not out:
        return cube.new_zeros((0, 2))
    return torch.cat(out)


def _masked_shifts(ref, movs, m1, m2, overlap_ratio):
    """Integer (B, 2) shifts of the masked normalized cross-correlation of
    a (B, ny, nx) batch of moving frames against one reference frame
    (vip_tpu registration.py:79-139), as a float tensor."""
    B, ny, nx = movs.shape
    fshape = (2 * ny - 1, 2 * nx - 1)

    def F(x):
        return torch.fft.fft2(x, s=fshape)

    def IF(x):
        return torch.fft.ifft2(x).real

    fixed = ref * m1
    moving = movs * m2
    rot_moving = torch.flip(moving, dims=(-2, -1))
    rot_m2 = torch.flip(m2, dims=(-2, -1))
    fixed_fft = F(fixed)
    rot_moving_fft = F(rot_moving)
    m1_fft = F(m1)
    rot_m2_fft = F(rot_m2)

    n_overlap = torch.clamp(IF(rot_m2_fft * m1_fft), min=_EPS)
    corr_fixed = IF(rot_m2_fft * fixed_fft)
    corr_moving = IF(m1_fft * rot_moving_fft)
    numerator = IF(rot_moving_fft * fixed_fft) \
        - corr_fixed * corr_moving / n_overlap
    fixed_den = IF(rot_m2_fft * F(fixed * fixed)) \
        - corr_fixed ** 2 / n_overlap
    moving_den = IF(m1_fft * F(rot_moving * rot_moving)) \
        - corr_moving ** 2 / n_overlap
    denom = torch.sqrt(torch.clamp(fixed_den, min=0)
                       * torch.clamp(moving_den, min=0))
    denom = denom.expand(B, -1, -1)
    numerator = numerator.expand(B, -1, -1)
    tol = 1e3 * _EPS * torch.abs(denom).reshape(B, -1).amax(dim=1)
    tol = tol[:, None, None]
    xcorr = torch.where(denom > tol, torch.clamp(
        numerator / torch.maximum(denom, tol), -1, 1), 0.0)
    n_overlap = n_overlap.expand(B, -1, -1)
    keep = n_overlap > overlap_ratio * n_overlap.reshape(B, -1).amax(
        dim=1)[:, None, None]
    xcorr = torch.where(keep, xcorr, 0.0)
    amax = torch.argmax(xcorr.reshape(B, -1), dim=1)
    idx = _unravel(amax, fshape[1])
    return (idx - torch.tensor([ny - 1, nx - 1], device=idx.device)).to(
        ref.dtype)


def masked_register_translation(reference_image, moving_image,
                                reference_mask, moving_mask=None,
                                overlap_ratio=0.3):
    """Masked translation registration (Padfield 2012; vip_tpu
    registration.py:79): integer-pixel shifts from the masked normalized
    cross-correlation, computed with FFTs of shape 2s - 1 on the frames'
    device. ``moving_image`` is a frame, or a (B, ny, nx) batch registered
    at once against the reference. Returns the (dy, dx) to apply to the
    moving frame as a numpy float array, (B, 2) for a batch."""
    ref = as_tensor(reference_image)
    if not ref.is_floating_point():
        ref = ref.to(torch.float64)
    mov = as_tensor(moving_image, ref.device, ref.dtype)
    m1 = as_tensor(np.asarray(reference_mask, dtype=float)
                   if not isinstance(reference_mask, torch.Tensor)
                   else reference_mask, ref.device, ref.dtype)
    m2 = m1 if moving_mask is None else as_tensor(
        np.asarray(moving_mask, dtype=float)
        if not isinstance(moving_mask, torch.Tensor) else moving_mask,
        ref.device, ref.dtype)
    single = mov.ndim == 2
    movs = mov[None] if single else mov
    cdtype = _complex(ref.dtype)
    # about eleven complex (2ny-1, 2nx-1) arrays a frame at the peak
    chunk = _frames_per_chunk(11, (2 * ref.shape[0] - 1,
                                   2 * ref.shape[1] - 1), cdtype)
    shifts = torch.cat([_masked_shifts(ref, movs[s:s + chunk], m1, m2,
                                       overlap_ratio)
                        for s in range(0, movs.shape[0], chunk)])
    out = shifts.cpu().numpy().astype(float)
    return out[0] if single else out

"""PCA sky subtraction with data imputation: the anchor/boat masks of
[REN23] (port of ``vip_tpu.preproc.skysubtraction``), also the engine of
``pca(..., mask_rdi=)``. Runs on the science cube's device; the
per-frame least-squares coefficients are two matrix products."""

import torch

from ..config.device import as_tensor

__all__ = ["cube_subtract_sky_pca"]


def cube_subtract_sky_pca(sci_cube, sky_cube, masks, ref_cube=None, ncomp=2,
                          full_output=False):
    """Subtract the optimal sky model, built from the principal components
    of ``sky_cube`` in the anchor region, from each science frame in the
    boat region (vip_tpu skysubtraction.py:12). ``masks`` is the anchor
    mask, or (anchor, boat). Returns tensors on the science cube's
    device: the sky-subtracted science cube (and reference cube), and with
    ``full_output`` also the sky cubes of the anchor and boat regions and
    the optimal sky model."""
    from ..psfsub.svd import svd_wrapper
    from ..var.shapes import prepare_matrix

    sci_cube = as_tensor(sci_cube)
    dev, dt = sci_cube.device, sci_cube.dtype
    sky_cube = as_tensor(sky_cube, dev, dt)
    if sci_cube.shape[1] != sky_cube.shape[1] or \
            sci_cube.shape[2] != sky_cube.shape[2]:
        raise TypeError("Science and Sky frames sizes do not match")
    if ref_cube is not None:
        ref_cube = as_tensor(ref_cube, dev, dt)
        if sci_cube.shape[1] != ref_cube.shape[1] or \
                sci_cube.shape[2] != ref_cube.shape[2]:
            raise TypeError("Science and Reference frames sizes do not "
                            "match")
    if type(masks) not in (list, tuple):
        mask_anchor = as_tensor(masks, dev, dt)
        mask_boat = torch.ones_like(mask_anchor)
    elif len(masks) != 2:
        raise TypeError("Science and Reference frames sizes do not match")
    else:
        mask_anchor, mask_boat = (as_tensor(m, dev, dt) for m in masks)

    def _apply_mask(cube, mask):
        return torch.where(mask[None] == 0, 0.0, cube)

    nsky = sky_cube.shape[0]
    sky_anchor = _apply_mask(sky_cube, mask_anchor).reshape(nsky, -1)
    Msci_masked_anchor = prepare_matrix(_apply_mask(sci_cube, mask_anchor),
                                        scaling=None, verbose=False)
    sci_cube_boat = _apply_mask(sci_cube, mask_boat)
    sky_boat = _apply_mask(sky_cube, mask_boat).reshape(nsky, -1)

    # principal components of the sky in the anchor region (KL trick)
    sky_kl = sky_anchor @ sky_anchor.T
    sky_pcs_kl = svd_wrapper(sky_kl, "lapack", nsky, False, to_numpy=False)
    sky_pc_anchor = sky_pcs_kl @ sky_anchor
    sky_anchor_cube = sky_pc_anchor.reshape(sky_cube.shape)
    sky_boat_cube = (sky_pcs_kl @ sky_boat).reshape(sky_cube.shape)

    # least-squares coefficients of every science frame on the anchor PCs
    mat_inv = torch.linalg.inv(sky_pc_anchor @ sky_pc_anchor.T)
    transf_sci_scaled = mat_inv @ (sky_pc_anchor @ Msci_masked_anchor.T)
    sky_opt = torch.einsum("ji,jyx->iyx", transf_sci_scaled[:ncomp],
                           sky_boat_cube[:ncomp])
    sci_cube_skysub = sci_cube_boat - sky_opt

    if ref_cube is not None:
        Mref_masked_anchor = prepare_matrix(_apply_mask(ref_cube, mask_anchor),
                                            scaling=None, verbose=False)
        transf_ref_scaled = mat_inv @ (sky_pc_anchor @ Mref_masked_anchor.T)
        ref_cube_skysub = _apply_mask(ref_cube, mask_boat) - torch.einsum(
            "ji,jyx->iyx", transf_ref_scaled[:ncomp], sky_boat_cube[:ncomp])
        if full_output:
            return (sci_cube_skysub, ref_cube_skysub, sky_anchor_cube,
                    sky_boat_cube, sky_opt)
        return sci_cube_skysub, ref_cube_skysub
    if full_output:
        return sci_cube_skysub, sky_anchor_cube, sky_boat_cube, sky_opt
    return sci_cube_skysub

"""Several devices: the NEGFC log-probability with the walkers laid over
the ranks of a mesh (port of ``vip_tpu.fm.sharded``).

The batched likelihood (``ops.negfc_model.make_batched_lnprob``: CUDA
kernels H2 and H1 on a card) needs no collective inside: walkers are
independent. Each rank evaluates its block of a batch of walkers, and
one all_gather hands every rank the batch's whole (nwalkers,) vector, so
the host stretch-move loop runs the same on every rank.
"""

import numpy as np
import torch

from ..config.parallel import all_gather, local_slab

__all__ = ["make_sharded_batched_lnprob"]


def make_sharded_batched_lnprob(mesh, *args, axis="walkers", **kwargs):
    """Sharded drop-in for ``ops.negfc_model.make_batched_lnprob``
    (vip_tpu sharded.py:21): (nwalkers, ndim) → (nwalkers,), a tensor on
    the cube's device on every rank. The walkers of a batch must divide
    evenly over the mesh; every rank passes the whole batch."""
    from ..ops.negfc_model import make_negfc_lnprob

    lnprob = make_negfc_lnprob(*args, **kwargs)

    def lnprob_batched(coords):
        if isinstance(coords, torch.Tensor):
            coords = coords.detach().cpu().numpy()
        coords = np.asarray(coords, dtype=float)
        mine = local_slab(coords, mesh, device="cpu", dtype=torch.float64)
        return all_gather(lnprob(mine.numpy()), mesh)

    return lnprob_batched

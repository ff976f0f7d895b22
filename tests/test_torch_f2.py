"""F2 on the CPU: the goldens' configurations on the NACO replica in
float32, against VIP's float64 frames.

The same float32 code on the card was 110x (``pca_adi``) and 23x
(``pca_ann_adi``) farther from the goldens than on the CPU until every
SVD of the port took cuSOLVER's QR-based gesvd (ROADMAP Queue 3, F2;
``ops.linalg.svd``). The card's gate is
tests/test_torch_cuda.py::test_goldens_in_float32_on_the_card, relative to
this CPU run; here the CPU run itself is held at the errors measured when
F2 was repaired (1.287e-03, 2.263e-04, 1.487e-03, 1.117e-04), with
about 1.5x room for another BLAS's order of summation, so that a float32
regression on the CPU shows in tier-1.
"""

import os

import numpy as np
import pytest
import torch

import vip_tpu_torch
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.ops.linalg import svd

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

F2 = (("pca_adi", "pca", dict(svd_mode="lapack"), 2e-3),
      ("medsub_adi", "median_sub", dict(mode="fullfr", imlib="vip-fft",
                                        interpolation=None), 3.5e-4),
      ("pca_ann_adi", "pca_annular", dict(n_segments="auto"), 2.2e-3),
      ("pca_incr_adi", "pca", dict(batch=30), 1.7e-4))


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    vip_tpu_torch.set_device("cpu")


@pytest.mark.parametrize("name,fn,kwargs,bound", F2,
                         ids=[c[0] for c in F2])
def test_goldens_in_float32_on_the_cpu(name, fn, kwargs, bound):
    meta = np.load(os.path.join(GOLDEN, "meta.npz"))
    cube = np.load(os.path.join(GOLDEN, "inputs.npz"))["cube"].astype(
        np.float32)
    frame = getattr(tps, fn)(cube=torch.as_tensor(cube),
                             angle_list=meta["angles"],
                             fwhm=float(meta["fwhm"]), verbose=False,
                             **kwargs)
    frame = frame.double().numpy() if isinstance(frame, torch.Tensor) \
        else np.asarray(frame, np.float64)
    err = np.abs(frame - np.load(os.path.join(GOLDEN, f"{name}.npy"))).max()
    assert err <= bound, f"{name}: {err:.3e} > {bound:.1e}"


def test_svd_is_torch_linalg_svd_on_the_cpu():
    a = torch.as_tensor(np.random.default_rng(0).standard_normal((9, 5)))
    for got, ref in zip(svd(a), torch.linalg.svd(a, full_matrices=False)):
        assert torch.equal(got, ref)

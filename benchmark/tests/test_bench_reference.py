"""The plain references agree with the program on the CPU at small sizes,
both in float64: full-frame PCA-ADI, and the single and double ADI+mSDI
passes."""

import pytest
import torch

from yardstick import check, harness, plain, sequences

from conftest import tiny

CASES = [
    ("adi512.pca_fullfr", {"svd_mode": "eigen", "imlib": "vip-fft",
                           "collapse": "median", "ncomp": 5}),
    ("adi512.pca_fullfr", {"svd_mode": "lapack", "ncomp": 9}),
    ("ifs290.pca_single", {"adimsdi": "single", "ncomp": 4}),
    ("ifs290.pca_single", {"adimsdi": "single", "ncomp": 12}),
    ("ifs290.pca_double", {"adimsdi": "double", "ncomp": (1, 5)}),
    ("ifs290.pca_double", {"adimsdi": "double", "ncomp": (3, 7)}),
]


@pytest.mark.parametrize("cell_name, kwargs", CASES)
def test_reference_agrees_with_the_program(cell_name, kwargs, cpu_port):
    from vip_tpu_torch.psfsub import pca

    cell = tiny(cell_name, dtype="float64")
    seq = sequences.make_sequence(cell.config, 2 ** 31 + 3, 0,
                                  torch.device("cpu"))
    kw = dict(kwargs, verbose=False)
    if "scale_list" in seq.extras:
        kw["scale_list"] = seq.extras["scale_list"]
    ref_mod = harness.load_module("references", cell.traffic["reference"])
    ref = ref_mod.reduce(seq.cube, seq.angles, kw)
    got = pca(seq.cube, seq.angles, **kw)
    assert got.dtype == torch.float64
    # the program rounds the zoom's input canvas to float32 (VIP's own
    # quirk): ~1e-8 of the input's scale in the 4-d passes
    assert check.frame_gap(got.numpy(), ref, check.input_scale(seq.cube)) \
        < 1e-7


def test_rotation_is_exact_for_quarter_turns():
    x = torch.randn(3, 16, 16, dtype=torch.float64)
    out = plain.rotate(x, [90.0, 180.0, 0.0])
    # VIP turns even frames about (y/2, x/2): a quarter turn is a rot90
    # shifted by one pixel, exact away from the edge it wraps
    assert torch.allclose(out[2], x[2], atol=1e-12)
    assert torch.allclose(out[1][1:, 1:], torch.flip(x[1], (0, 1))[:-1, :-1],
                          atol=1e-10)


def test_zoom_conserves_flux():
    x = torch.zeros(1, 64, 64, dtype=torch.float64)
    r = torch.arange(64, dtype=torch.float64) - 32
    x[0] = torch.exp(-(r[:, None] ** 2 + r[None] ** 2) / 20)
    for s in (1.2, 0.8, 1.4210526):
        z = plain.zoom(x, s)
        assert float(z.sum()) == pytest.approx(float(x.sum()), rel=1e-6)


def test_median_is_numpy_median():
    import numpy as np

    x = torch.randn(10, 7, 5, dtype=torch.float64)
    for n in (10, 9):
        np.testing.assert_allclose(plain.median0(x[:n], block=6).numpy(),
                                   np.median(x[:n].numpy(), axis=0))

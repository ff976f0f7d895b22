"""The port's ``ops.interp_rotation`` (vip_tpu's own gather rotation,
cube_derotate's 'tpu-interp' and the pipelines' ``rot_mode="interp"``)
against vip_tpu on the CPU at float64 (jax x64).

The sampling is the same float64 arithmetic in another library (the
bicubic weights by an equal polynomial in another order): held at 1e-12
of max(|ref|, 1). The pipeline adds the 30x30 Gram eigh, held at 1e-7 as
in test_torch_pipeline.py.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

import jax.numpy as jnp

from conftest import make_adi_cube
from vip_tpu.ops import interp_rotation as jint
from vip_tpu.ops import pipeline as jpipe
from vip_tpu_torch.ops import interp_rotation as tint
from vip_tpu_torch.ops import median, pipeline, shear

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


TOL = 1e-12
PIPE_TOL = 1e-7


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("shape", [(32, 32), (33, 33), (30, 37)])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_rotate_interp_batch(mode, shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    cube = rng.standard_normal((6,) + shape)
    angles = np.array([0.0, 13.7, -41.3, 90.0, 179.5, -270.25])
    ref = jint.rotate_interp_batch(jnp.asarray(cube), jnp.asarray(angles),
                                   mode=mode)
    got = tint.rotate_interp_batch(torch.from_numpy(cube),
                                   torch.from_numpy(angles), mode=mode)
    assert got.dtype == torch.float64
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_rotate_interp_one_frame_and_chunks(mode, monkeypatch):
    rng = np.random.default_rng(5)
    cube = rng.standard_normal((5, 21, 21))
    angles = np.linspace(-100, 100, 5)
    ref = jint.rotate_interp(jnp.asarray(cube[2]), 33.3, mode=mode)
    assert _err(tint.rotate_interp(torch.from_numpy(cube[2]), 33.3,
                                   mode=mode), ref) <= TOL
    whole = tint.rotate_interp_batch(torch.from_numpy(cube), angles, mode)
    monkeypatch.setattr(tint, "_CHUNK_BYTES", 120 * 21 * 21 * 2)
    assert torch.equal(tint.rotate_interp_batch(torch.from_numpy(cube),
                                                angles, mode), whole)


@pytest.fixture(scope="module")
def cube():
    return make_adi_cube(n=30, size=64)


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
def test_pca_adi_pipeline_interp(cube, interpolation, chunk):
    c, ang = cube
    ref = jpipe.pca_adi_pipeline(jnp.asarray(c), jnp.asarray(ang), ncomp=5,
                                 rot_mode="interp",
                                 interpolation=interpolation)
    before = (median.launches, shear.launches)
    got = pipeline.pca_adi_pipeline(c, ang, ncomp=5, rot_mode="interp",
                                    interpolation=interpolation, chunk=chunk)
    assert (median.launches, shear.launches) == before    # CPU: plain
    assert _err(got, ref) <= PIPE_TOL


def test_derotate_collapse_interp(cube):
    c, ang = cube
    ref = jpipe.derotate_collapse(jnp.asarray(c), jnp.asarray(ang),
                                  rot_mode="interp")
    got = pipeline.derotate_collapse(torch.from_numpy(c),
                                     torch.from_numpy(ang),
                                     rot_mode="interp")
    assert _err(got, ref) <= TOL

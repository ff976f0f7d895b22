"""Port's end-to-end pipelines (ops/pipeline.py) against vip_tpu on the CPU
at float64, on ``make_adi_cube(n=30, size=64)``.

The eigen SVD (vip_tpu's and the port's pipeline default) diagonalizes the
30x30 Gram matrix with two LAPACK routines; at ncomp=5 the residual frames
agree to ~1e-8 of their scale, held at 1e-7. Rotation and median are the
same float64 arithmetic (see test_torch_rotation.py, test_torch_median.py).
The port's chunks are even: the packed fft-small rotation rides frames in
pairs and drops each shear's imaginary residue, so its result depends on
which frames share a pack.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import make_adi_cube
from vip_tpu.ops import pipeline as jpipe
from vip_tpu_torch.ops import median, pipeline, shear

torch.set_num_threads(1)

TOL = 1e-7


@pytest.fixture(scope="module")
def cube():
    return make_adi_cube(n=30, size=64)


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("collapse", ["median", "mean"])
@pytest.mark.parametrize("rot_mode", ["fft", "fft-small"])
def test_pca_adi_pipeline_vs_vip_tpu(cube, rot_mode, collapse):
    c, ang = cube
    ref = jpipe.pca_adi_pipeline(jnp.asarray(c), jnp.asarray(ang), ncomp=5,
                                 collapse=collapse, rot_mode=rot_mode)
    before = (median.launches, shear.launches)
    got = pipeline.pca_adi_pipeline(c, ang, ncomp=5, collapse=collapse,
                                    rot_mode=rot_mode, chunk=6)
    assert (median.launches, shear.launches) == before   # CPU: plain
    assert got.dtype == torch.float64 and tuple(got.shape) == (64, 64)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("rot_mode", ["fft", "fft-small"])
def test_derotate_collapse_vs_vip_tpu(cube, rot_mode):
    c, ang = cube
    ref = jpipe.derotate_collapse(jnp.asarray(c), jnp.asarray(ang),
                                  rot_mode=rot_mode)
    got = pipeline.derotate_collapse(torch.from_numpy(c),
                                     torch.from_numpy(ang), chunk=8,
                                     rot_mode=rot_mode)
    assert _err(got, ref) <= TOL


@pytest.mark.parametrize("collapse", ["median", "mean"])
def test_median_adi_pipeline_vs_vip_tpu(cube, collapse):
    c, ang = cube
    ref = jpipe.median_adi_pipeline(jnp.asarray(c), jnp.asarray(ang),
                                    collapse=collapse)
    got = pipeline.median_adi_pipeline(c, ang, collapse=collapse)
    assert _err(got, ref) <= TOL


def test_interp_rotation_waits(cube):
    c, ang = cube
    with pytest.raises(NotImplementedError):
        pipeline.pca_adi_pipeline(c, ang, rot_mode="interp")

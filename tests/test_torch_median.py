"""Port's median (ops/median.py) and collapse (preproc/subsampling.py)
against numpy and vip_tpu.

The plain median must be bit-equal to vip_tpu's Pallas kernel
``nanmedian_axis0`` (run in interpret mode, as tests/test_pallas_median.py
does) at float32, and within 1 float32 ulp of numpy's nanmedian/median,
whose float64 average of the two middles rounds once more. The CUDA kernel
H1 against the plain version on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vip_tpu.ops.pallas_median import nanmedian_axis0 as pallas_nanmedian
from vip_tpu.preproc.subsampling import collapse_jax as jax_collapse
from vip_tpu_torch.ops import median
from vip_tpu_torch.ops.median import nanmedian_axis0, nanmedian_plain
from vip_tpu_torch.preproc.subsampling import collapse_jax, cube_collapse
from test_torch_cuda import _specials

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("propagate", [False, True])
@pytest.mark.parametrize("shape", [(8, 128), (11, 150)])
@pytest.mark.parametrize("n", [16, 17])
def test_plain_median_vs_numpy_and_pallas(n, shape, propagate):
    arr = _specials(n, shape, seed=n)
    got = nanmedian_axis0(torch.from_numpy(arr), propagate=propagate).numpy()

    with np.errstate(all="ignore"):
        ref = (np.median if propagate else np.nanmedian)(
            arr.astype(np.float64), axis=0)

    # XLA's CPU backend flushes denormal results to zero, so where the
    # median itself is denormal the interpret-mode Pallas kernel returns
    # ±0; the port keeps the denormal, as numpy does. Bit-equal elsewhere.
    pallas = np.asarray(pallas_nanmedian(jnp.asarray(arr), interpret=True,
                                         propagate=propagate))
    denormal = (ref != 0) & (np.abs(ref) < np.finfo(np.float32).tiny)
    assert np.all(pallas[denormal] == 0)
    np.testing.assert_array_equal(_bits(got)[~denormal],
                                  _bits(pallas)[~denormal])
    np.testing.assert_array_equal(got[denormal],
                                  ref[denormal].astype(np.float32))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(ref)
    ulp = np.spacing(np.abs(ref[ok]).astype(np.float32))
    assert np.all(np.abs(got[ok] - ref[ok]) <= ulp)
    np.testing.assert_array_equal(got[~ok & ~np.isnan(ref)],
                                  ref[~ok & ~np.isnan(ref)])


def test_plain_median_float64_is_numpy_exactly():
    arr = _specials(20, (6, 9), seed=5).astype(np.float64)
    arr[:, 5, 5] = np.linspace(-1, 1, 20) ** 3
    with np.errstate(all="ignore"):
        ref = np.nanmedian(arr, axis=0)
    got = nanmedian_plain(torch.from_numpy(arr), 0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cpu_tensor_takes_plain_version_without_launch():
    before = median.launches
    arr = torch.from_numpy(_specials(16, (8, 9), seed=1))
    nanmedian_axis0(arr)
    assert median.launches == before


_MODES = ["median", "mean", "sum", "max", "absmean", "trimmean", "wmean"]


@pytest.mark.parametrize("mode", _MODES)
def test_collapse_vs_vip_tpu(mode):
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((24, 7, 9))
    arr[3, 1, 1] = np.nan
    arr[:, 2, 2] = np.nan
    w = rng.random(24)
    with np.errstate(all="ignore"):
        ref = np.asarray(jax_collapse(jnp.asarray(arr), mode=mode, n=10,
                                      w=w))
    got = collapse_jax(torch.from_numpy(arr), mode=mode, n=10, w=w).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)


def test_cube_collapse_4d_median_over_time():
    rng = np.random.default_rng(6)
    arr = rng.standard_normal((3, 11, 5, 5))
    got = cube_collapse(arr, mode="median").numpy()
    np.testing.assert_array_equal(got, np.median(arr, axis=1))

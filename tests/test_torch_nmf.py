"""Port's NMF (``ops.nmf``, ``psfsub.nmf``, ``psfsub.nmf_annular``)
against vip_tpu on the CPU at float64, and the NMF goldens.

- ``nmf_fit`` / ``nmf_transform`` for each init and the batched per-frame
  fits, with vip_tpu's ``jax.random.PRNGKey(0)`` draws computed here and
  passed in (``draws=``), at 1e-9 of max(|ref|, 1): the same float64
  multiplicative updates, SVDs from another LAPACK call, hundreds of
  iterations.
- ``nmf`` for each ``handle_neg``, with a reference cube, a signal cube
  and the per-frame PA-threshold libraries, at the same bound;
  ``nmf_annular`` on a few annuli through the batched and the per-frame
  fits at 1e-8: the batched fits take their NNDSVD from the eigenpairs
  of each library's Gram (one cuSOLVER call a matrix either way on the
  card, and eigh is the cheaper), which squares the condition number
  (3.4e-09 measured).
- The goldens nmf_adi and nmf_drot_adi (VIP's detections on the NACO
  replica; VIP's NMF frames are not reproducible, tests/test_golden.py:
  115): the port's own ``detection`` finds every planted companion that
  VIP's found, within 3 px; nmf_ann_adi in the slow lane, as vip_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import vip_tpu_torch

from conftest import make_adi_cube
from gen_golden import psfsub_configs
import vip_tpu.ops.nmf as jnmf
import vip_tpu.psfsub as jps
import vip_tpu_torch.ops.nmf as tnmf
import vip_tpu_torch.psfsub as tps
from vip_tpu_torch.psfsub import nmf_local
from test_torch_llsg import check_detection, golden_ds  # noqa: F401

torch.set_num_threads(1)

TOL = 1e-9
ANNULAR_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode)."""
    vip_tpu_torch.set_device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    with threadpoolctl.threadpool_limits(1, user_api="blas"):
        yield


def _err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0)


def _jax_draws(shape_w, shape_h):
    """vip_tpu's draws: ``split(PRNGKey(0))``, one normal array each."""
    kW, kH = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.normal(kW, shape_w, jnp.float64)),
            np.asarray(jax.random.normal(kH, shape_h, jnp.float64)))


@pytest.fixture(scope="module")
def matrix():
    rng = np.random.default_rng(0)
    return np.abs(rng.standard_normal((30, 200))) + 0.1


@pytest.mark.parametrize("init", ["nndsvd", "nndsvda", "nndsvdar", "random"])
def test_nmf_fit_and_transform_vs_vip_tpu(matrix, init):
    k = 5
    W, H, it = jnmf.nmf_fit(matrix, k, max_iter=200, init=init)
    draws = _jax_draws((matrix.shape[0], k), (k, matrix.shape[1])) \
        if init in ("nndsvdar", "random") else None
    W2, H2, it2 = tnmf.nmf_fit(matrix, k, max_iter=200, init=init,
                               draws=draws)
    assert it2 == int(it)
    assert _err(H2, H) <= TOL
    assert _err(W2 @ H2, np.asarray(W) @ np.asarray(H)) <= TOL
    Wt = jnmf.nmf_transform(matrix[:3], H, max_iter=200)
    assert _err(tnmf.nmf_transform(matrix[:3], torch.as_tensor(
        np.asarray(H)), max_iter=200), Wt) <= TOL


def test_draws_are_checked_and_the_default_is_seeded(matrix):
    with pytest.raises(ValueError, match="draws must have shapes"):
        tnmf.nmf_fit(matrix, 5, init="random",
                     draws=(np.zeros((3, 5)), np.zeros((5, 200))))
    a = tnmf.nmf_fit(matrix, 5, max_iter=20, init="nndsvdar")[1]
    b = tnmf.nmf_fit(matrix, 5, max_iter=20, init="nndsvdar")[1]
    assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["nndsvd", "nndsvda", "nndsvdar"])
def test_nmf_patch_batched_vs_vip_tpu(variant):
    rng = np.random.default_rng(1)
    B, L, p, k = 4, 16, 120, 4
    X = np.abs(rng.standard_normal((B, L, p))) + 0.1
    valid = np.ones((B, L))
    for b, n in ((1, 12), (2, 10)):
        X[b, n:] = 0
        valid[b, n:] = 0
    curr = np.abs(rng.standard_normal((B, p)))
    recon, H = jnmf.nmf_patch_batched(jnp.asarray(X), jnp.asarray(valid),
                                      jnp.asarray(curr), k, max_iter=300,
                                      variant=variant)
    recon2, H2 = tnmf.nmf_patch_batched(
        torch.as_tensor(X), torch.as_tensor(valid), torch.as_tensor(curr),
        k, max_iter=300, variant=variant, draws=_jax_draws((L, k), (k, p)))
    assert _err(recon2, recon) <= TOL
    assert _err(H2, H) <= TOL


@pytest.fixture(scope="module")
def small():
    cube, angles = make_adi_cube(n=30, size=41)
    ref = make_adi_cube(n=12, size=41, rng=np.random.default_rng(9))[0]
    return cube, angles, ref


@pytest.mark.parametrize("kw", [
    dict(handle_neg="mask"),
    dict(handle_neg="null", shift=-20),
    dict(handle_neg="subtr_min", shift=-20),
    dict(handle_neg="mask", mask_center_px=4, full_output=True),
    dict(handle_neg="null", shift=-20, full_output=True),
    dict(handle_neg="subtr_min", init_svd="nndsvda", collapse="mean"),
    dict(handle_neg="mask", cube_ref=True),
    dict(handle_neg="subtr_min", cube_sig=True),
    dict(handle_neg="mask", source_xy=(32, 20), delta_rot=0.5),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_nmf_vs_vip_tpu(small, kw):
    cube, angles, ref_cube = small
    kw = dict(kw)
    cube = cube + kw.pop("shift", 0)
    if kw.pop("cube_ref", False):
        kw["cube_ref"] = ref_cube
    if kw.pop("cube_sig", False):
        kw["cube_sig"] = 0.01 * cube
    args = dict(ncomp=3, max_iter=200, verbose=False, **kw)
    ref = jps.nmf(cube=cube.copy(), angle_list=angles, **args)
    got = tps.nmf(cube=cube.copy(), angle_list=angles, **args)
    if kw.get("full_output"):
        assert len(got) == len(ref) == 5
        for g, r in zip(got, ref):
            assert _err(g, r) <= TOL
    else:
        assert got.dtype == torch.float64
        assert _err(got, ref) <= TOL


@pytest.mark.parametrize("kw", [
    dict(handle_neg="mask"),
    dict(handle_neg="subtr_min", shift=-20, full_output=True),
    dict(handle_neg="null", shift=-20, n_segments=2),
    dict(handle_neg="mask", per_frame=True),
    dict(handle_neg="subtr_min", cube_ref=True, delta_rot=0.5),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_nmf_annular_vs_vip_tpu(small, monkeypatch, kw):
    cube, angles, ref_cube = small
    kw = dict(kw)
    cube = cube + kw.pop("shift", 0)
    if kw.pop("per_frame", False):
        monkeypatch.setenv("VIP_TPU_NMF_BATCHED", "0")
    if kw.pop("cube_ref", False):
        kw["cube_ref"] = ref_cube
    args = dict(ncomp=3, radius_int=6, asize=4, max_iter=200,
                verbose=False, **kw)
    ref = jps.nmf_annular(cube=cube.copy(), angle_list=angles, **args)
    got = tps.nmf_annular(cube=cube.copy(), angle_list=angles, **args)
    if kw.get("full_output"):
        assert len(got) == len(ref) == 5
        for g, r in zip(got, ref):
            assert _err(g, r) <= ANNULAR_TOL
    else:
        assert _err(got, ref) <= ANNULAR_TOL


def test_nmf_annular_in_chunks_of_frames(small, monkeypatch):
    """Chunks of a few frames give the frame of one chunk, nndsvdar's
    shared draw included."""
    cube, angles, _ = small
    args = dict(ncomp=3, radius_int=6, asize=4, max_iter=100,
                init_svd="nndsvdar", verbose=False)
    whole = tps.nmf_annular(cube=cube.copy(), angle_list=angles, **args)
    monkeypatch.setattr(nmf_local, "_BATCH_BUDGET_BYTES",
                        7 * nmf_local._BATCH_COPIES * 32 * 8 * 400)
    assert _err(tps.nmf_annular(cube=cube.copy(), angle_list=angles,
                                **args), whole.numpy()) <= 1e-12


@pytest.mark.parametrize("name", [
    "nmf_adi", "nmf_drot_adi",
    pytest.param("nmf_ann_adi", marks=pytest.mark.slow)])
def test_golden_detection_nmf(golden_ds, name):  # noqa: F811
    for cname, fn, kwargs, _ in psfsub_configs(golden_ds):
        if cname == name:
            frame = getattr(tps, fn)(cube=golden_ds["cube"].copy(),
                                     angle_list=golden_ds["angles"], **kwargs)
            break
    else:
        raise KeyError(name)
    check_detection(frame.numpy(), golden_ds, name)

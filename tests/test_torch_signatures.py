"""Positional signatures of the port against vip_tpu.

Every public top-level function that the port has under the same module
and name as vip_tpu must bind a call in vip_tpu's positional order the
same way: vip_tpu's positional parameter names are a prefix of the
port's (a port may add trailing ones), with one documented rename: the
random ``key`` of ``ops.linalg`` is the port's ``omega`` sketch. The
public methods (and constructors) of the object layer's classes
(``objects``, ``metrics.roc.EvalRoc``, ``vip_ds9.Ds9Window``) are held
the same way. Both packages are parsed with ``ast``, not imported. Then
the two calls that
the old order bound wrongly (ROADMAP Queue 3, F1) run against vip_tpu on
the CPU at float64.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vip_tpu_torch
from vip_tpu.ops import linalg as jlin
from vip_tpu_torch.ops import linalg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENAMED = {"key": "omega"}
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _positional(package):
    """{(module, function): positional parameter names} of the public
    top-level functions of a package directory."""
    top = os.path.join(ROOT, package)
    out = {}
    for dirpath, _, files in os.walk(top):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            module = os.path.relpath(path, top)[:-3].replace(os.sep, ".")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if isinstance(node, ast.FunctionDef) \
                        and not node.name.startswith("_"):
                    args = node.args.posonlyargs + node.args.args
                    out[(module, node.name)] = [a.arg for a in args]
    return out


# the modules whose classes' methods are held to vip_tpu's order
CLASS_MODULES = ("objects.", "metrics.roc", "vip_ds9")


def _methods(package):
    """{(module, class.method): positional parameter names} of the public
    methods and constructors of the classes of CLASS_MODULES."""
    top = os.path.join(ROOT, package)
    out = {}
    for dirpath, _, files in os.walk(top):
        for name in files:
            path = os.path.join(dirpath, name)
            module = os.path.relpath(path, top)[:-3].replace(os.sep, ".")
            if not name.endswith(".py") or not module.startswith(
                    CLASS_MODULES):
                continue
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if not isinstance(node, ast.ClassDef):
                    continue
                for fn in node.body:
                    if isinstance(fn, ast.FunctionDef) and (
                            fn.name == "__init__"
                            or not fn.name.startswith("_")):
                        args = fn.args.posonlyargs + fn.args.args
                        out[(module, f"{node.name}.{fn.name}")] = \
                            [a.arg for a in args]
    return out


def _common_methods():
    ours, theirs = _methods("vip_tpu_torch"), _methods("vip_tpu")
    return [(k, theirs[k], ours[k]) for k in sorted(set(ours) & set(theirs))]


def test_shared_methods_are_many():
    # Dataset, Frame, PostProc, the PP classes, PPResult, EvalRoc and
    # Ds9Window: every method of vip_tpu's is the port's too
    theirs = _methods("vip_tpu")
    assert len(theirs) >= 80
    assert set(theirs) <= set(_methods("vip_tpu_torch")), \
        sorted(set(theirs) - set(_methods("vip_tpu_torch")))


@pytest.mark.parametrize("key,theirs,ours", _common_methods(),
                         ids=[".".join(k) for k, _, _ in _common_methods()])
def test_method_positional_order_of_vip_tpu(key, theirs, ours):
    assert ours[:len(theirs)] == theirs, f"{key}: {ours} against {theirs}"


def _common():
    ours, theirs = _positional("vip_tpu_torch"), _positional("vip_tpu")
    return [(k, theirs[k], ours[k]) for k in sorted(set(ours) & set(theirs))]


def test_shared_functions_are_many():
    # the slices ported so far share over a hundred functions
    assert len(_common()) >= 110


@pytest.mark.parametrize("key,theirs,ours", _common(),
                         ids=[".".join(k) for k, _, _ in _common()])
def test_positional_order_of_vip_tpu(key, theirs, ours):
    want = [RENAMED.get(a, a) if key[0] == "ops.linalg" else a
            for a in theirs]
    assert ours[:len(want)] == want, f"{key}: {ours} against {theirs}"


def test_generator_is_keyword_only():
    tree = ast.parse(open(os.path.join(ROOT, "vip_tpu_torch", "ops",
                                       "linalg.py")).read())
    kwonly = {n.name: [a.arg for a in n.args.kwonlyargs] for n in tree.body
              if isinstance(n, ast.FunctionDef)}
    for name in ("randomized_svd", "svd_top", "project_subtract"):
        assert kwonly[name] == ["generator"]


def test_nmf_draws_are_keyword_only():
    """The draw arguments the port adds to vip_tpu's NMF (whose draws are
    ``jax.random.PRNGKey(0)``) come after every positional one."""
    tree = ast.parse(open(os.path.join(ROOT, "vip_tpu_torch", "ops",
                                       "nmf.py")).read())
    kwonly = {n.name: [a.arg for a in n.args.kwonlyargs] for n in tree.body
              if isinstance(n, ast.FunctionDef)}
    for name in ("nndsvd_init", "nmf_fit", "nmf_patch_batched"):
        assert kwonly[name] == ["draws", "generator"]


@pytest.fixture(scope="module")
def matrix():
    rng = np.random.default_rng(11)
    return rng.standard_normal((12, 40)), rng.standard_normal((12, 40))


def test_svd_top_full_output_positionally(matrix):
    M, _ = matrix
    theirs = jlin.svd_top(jnp.asarray(M), 4, "lapack", None, True)
    ours = linalg.svd_top(torch.from_numpy(M), 4, "lapack", None, True)
    assert isinstance(ours, tuple) and len(ours) == 3
    U, S, V = (np.asarray(a) for a in theirs)
    u, s, v = (a.numpy() for a in ours)
    np.testing.assert_allclose(s, S, atol=TOL)
    # singular vectors up to sign: compare the rank-4 reconstruction
    np.testing.assert_allclose(u @ np.diag(s) @ v, U @ np.diag(S) @ V,
                               atol=TOL)


def test_project_subtract_signal_positionally(matrix):
    M, sig = matrix
    theirs = np.asarray(jlin.project_subtract(
        jnp.asarray(M), None, 4, "lapack", None, jnp.asarray(sig)))
    ours = linalg.project_subtract(torch.from_numpy(M), None, 4, "lapack",
                                   None, torch.from_numpy(sig)).numpy()
    without = linalg.project_subtract(torch.from_numpy(M), None, 4,
                                      "lapack").numpy()
    np.testing.assert_allclose(ours, theirs, atol=TOL)
    assert np.abs(ours - without).max() > 1e-3   # the signal was used


def test_fft_shear_accepts_phase():
    from vip_tpu.ops.fft import fft_shear as jshear
    from vip_tpu_torch.ops.fft import fft_shear

    arr = np.random.default_rng(2).standard_normal((16, 16))
    for ax in (0, 1):
        theirs = np.asarray(jshear(jnp.asarray(arr, jnp.complex128), 0.3,
                                   ax, phase=None))
        ours = fft_shear(torch.from_numpy(arr), 0.3, ax, None).numpy()
        np.testing.assert_allclose(ours, theirs, atol=TOL)

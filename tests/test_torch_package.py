"""The port's package boundary: no file under vip_tpu_torch/ imports jax or
vip_tpu, and every module imports on a host with no nvcc and no triton
without building anything.

The import check runs in a fresh interpreter: a ``sys.modules`` check in
this process cannot work, because the vip_tpu tests (and this image's
interpreter start-up) import jax into every test process.
"""

import ast
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vip_tpu_torch")


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_or_vip_tpu_imports():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 20
    bad = {f: r for f in files
           for r in [_imported_roots(f) & {"jax", "jaxlib", "vip_tpu"}] if r}
    assert not bad, bad
    assert "jax" not in _imported_roots(os.path.join(REPO, "chip_smoke.py"))


_IMPORT_ALL = """
import importlib, pkgutil, shutil, sys
sys.modules["triton"] = None          # importing triton now raises
assert shutil.which("nvcc") is None
import vip_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vip_tpu_torch.__path__,
                                               "vip_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from vip_tpu_torch import _build
assert _build._lib is None            # nothing was built or loaded
print(len(names))
"""


def test_package_imports_without_nvcc_or_triton():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20

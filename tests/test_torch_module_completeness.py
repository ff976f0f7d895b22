"""The port is complete, module by module: for every module of vip_tpu,
each public top-level function and class has a counterpart of the same
name in the port's module of the same path, and each public method of
each public class exists on the port's class of the same name.

A counterpart is a name the port's module binds at its top level: a
``def``, a ``class``, an import or an assignment. vip_tpu's two Pallas
modules map onto the modules of their CUDA kernels. Both packages are
parsed with ``ast``; neither is imported. Nothing is exempt.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# vip_tpu's Pallas modules and the port's modules of their CUDA kernels
RENAMED = {"ops.pallas_median": "ops.median", "ops.pallas_shear": "ops.shear"}
PALLAS_NAMES = {
    "ops.pallas_median": {"nanmedian_axis0", "nanmedian_supported"},
    "ops.pallas_shear": {"rotate_fft_exact_fused", "rotate_fft_exact_fused3",
                         "rotate_fft_small_fused", "rotate_fft_small_fused3",
                         "fused_shear_supported", "fused_small_supported"},
}
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _modules(package):
    """{dotted module path: parsed module} of a package directory."""
    top = os.path.join(ROOT, package)
    out = {}
    for dirpath, _, files in os.walk(top):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                module = os.path.relpath(path, top)[:-3].replace(os.sep, ".")
                with open(path) as fh:
                    out[module] = ast.parse(fh.read(), path)
    return out


THEIRS, OURS = _modules("vip_tpu"), _modules("vip_tpu_torch")


def _public_defs(tree):
    """The public functions and classes a module defines at its top."""
    return {n.name for n in tree.body
            if isinstance(n, _DEFS) and not n.name.startswith("_")}


def _bound(tree):
    """Every name a module binds at its top level."""
    names = set()
    for node in tree.body:
        if isinstance(node, _DEFS):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
    return names


def _classes(modules):
    """{class name: [ClassDef, ...]} over every module of a package."""
    out = {}
    for tree in modules.values():
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                out.setdefault(node.name, []).append(node)
    return out


OUR_CLASSES = _classes(OURS)


def _members(cls, seen=()):
    """The names a class body binds, with those of its bases that the
    port defines (by name), as far as they go."""
    names = set()
    for node in cls.body:
        if isinstance(node, _DEFS):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
    for base in cls.bases:
        name = base.id if isinstance(base, ast.Name) else \
            base.attr if isinstance(base, ast.Attribute) else None
        if name and name not in seen:
            for parent in OUR_CLASSES.get(name, ()):
                names |= _members(parent, seen + (cls.name,))
    return names


def _public_methods(cls):
    return {n.name for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not n.name.startswith("_")}


MODULES = sorted(THEIRS)


def test_every_module_has_its_counterpart():
    assert len(THEIRS) >= 110
    missing = sorted(m for m in THEIRS if RENAMED.get(m, m) not in OURS)
    assert not missing, f"the port has no module for {missing}"


@pytest.mark.parametrize("module", MODULES)
def test_module_names_are_the_ports(module):
    theirs = _public_defs(THEIRS[module])
    ours = _bound(OURS[RENAMED.get(module, module)])
    missing = sorted(theirs - ours)
    assert not missing, \
        f"vip_tpu_torch.{RENAMED.get(module, module)} lacks {missing}"


@pytest.mark.parametrize("module", sorted(PALLAS_NAMES))
def test_pallas_modules_map_to_the_kernel_modules(module):
    """The eight public names of the Pallas modules, all of them, in the
    port's modules of H1 (ops/median.py) and H2-H4 (ops/shear.py), each
    a function there."""
    assert _public_defs(THEIRS[module]) == PALLAS_NAMES[module]
    ours = OURS[RENAMED[module]]
    defs = {n.name for n in ours.body if isinstance(n, ast.FunctionDef)}
    assert PALLAS_NAMES[module] <= defs, sorted(PALLAS_NAMES[module] - defs)


def _class_cases():
    cases = []
    for module in MODULES:
        for node in THEIRS[module].body:
            if isinstance(node, ast.ClassDef) \
                    and not node.name.startswith("_"):
                cases.append((module, node))
    return cases


CLASS_CASES = _class_cases()


@pytest.mark.parametrize("module,cls", CLASS_CASES,
                         ids=[f"{m}.{c.name}" for m, c in CLASS_CASES])
def test_class_methods_are_the_ports(module, cls):
    ours = [n for n in OURS[RENAMED.get(module, module)].body
            if isinstance(n, ast.ClassDef) and n.name == cls.name]
    if not ours:
        # imported into the port's module: its definition elsewhere
        ours = OUR_CLASSES.get(cls.name, [])
    assert ours, f"the port has no class {cls.name} (vip_tpu.{module})"
    missing = sorted(_public_methods(cls) - _members(ours[0]))
    assert not missing, f"{cls.name} of the port lacks {missing}"


def test_the_classes_are_many():
    # Dataset, Frame, PostProc, the PP classes and their builders,
    # PPResult, EvalRoc, Ds9Window, the parameter dataclasses, the disk
    # model's classes, ...
    assert len(CLASS_CASES) >= 60

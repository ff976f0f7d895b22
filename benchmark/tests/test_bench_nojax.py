"""Nothing the benchmark loads imports JAX or the JAX package. The repo's
root conftest imports jax into the test process, so the check runs in a
fresh interpreter."""

import os
import subprocess
import sys

from yardstick import harness

SCRIPT = r"""
import glob, importlib, json, os, sys
bench = sys.argv[1]
sys.path[:0] = [os.path.dirname(bench), bench]
from yardstick import harness, check, plain, roofline, sequences, trace
from yardstick import traffic, window, params
spec = harness.load_json(os.path.join(os.path.dirname(bench),
                                      "BENCHMARK.json"))
for w in spec["workloads"]:
    cell = harness.load_cell(w["name"], spec)
    traffic.resolve_entry(cell.traffic)
    harness.load_module("references", cell.traffic["reference"])
    for m in cell.end_to_end + cell.per_layer:
        harness.load_module("metrics", m["name"])
    for names in cell.layers.values():
        for mod, attr in names:
            getattr(importlib.import_module(mod), attr)
harness.counters_reader()()
for kind in ("metrics", "references"):
    for f in glob.glob(os.path.join(bench, kind, "*.py")):
        harness.load_module(kind, os.path.basename(f)[:-3])
print(json.dumps(harness.forbidden_modules()))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_fresh_interpreter_loads_no_jax():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", SCRIPT, harness.BENCH],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    bad, loaded = (__import__("json").loads(line)
                   for line in out.stdout.strip().splitlines()[-2:])
    assert bad == []
    assert "vip_tpu_torch" in loaded and "torch" in loaded
    assert not {"jax", "jaxlib", "flax", "vip_tpu"} & set(loaded)


def test_the_top_level_name_is_compared_whole(monkeypatch):
    names = {"vip_tpu_torch": 0, "vip_tpu_torch.ops": 0, "vip_tpuish": 0,
             "jaxtyping": 0, "numpy": 0}
    monkeypatch.setattr(sys, "modules", dict(names))
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**names, "vip_tpu.psfsub": 0,
                                         "jax._src": 0})
    assert harness.forbidden_modules() == ["jax", "vip_tpu"]

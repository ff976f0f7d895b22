"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the plain reference, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the configuration's file, the traffic file
``benchmark/traffic/<traffic>.json``, each metric's reader
``benchmark/metrics/<metric>.py``, each layer's wrapped attributes
``benchmark/layers/<layer>.json``, and the reference
``benchmark/references/<reference>.py`` that the traffic file names.
"""

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "vip_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    if not os.path.exists(path):
        raise BenchError(f"no file {path} for {kind[:-1]} {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list           # metric entries of BENCHMARK.json
    per_layer: list
    layers: dict               # {layer: [(module, attribute), ...]}


def load_cell(name, spec=None):
    """The cell ``name`` of BENCHMARK.json with every file it names."""
    spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(BENCH, "traffic",
                                     f"{w['traffic']}.json"))
    e2e = [m for m in spec["end_to_end"] if _for_cell(m, name)]
    per_layer = [m for m in spec["per_layer"] if _for_cell(m, name)]
    layers = {}
    for m in per_layer:
        lf = load_json(os.path.join(BENCH, "layers", f"{m['layer']}.json"))
        layers[m["layer"]] = [tuple(a.split(":")) for a in lf["wrap"]]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer, layers)


def counters_reader():
    """A function reading the program's launch counters named in
    ``benchmark/counters.json`` ({name: "module:attribute"})."""
    names = load_json(os.path.join(BENCH, "counters.json"))
    mods = {k: (importlib.import_module(v.split(":")[0]), v.split(":")[1])
            for k, v in names.items()}
    return lambda: {k: int(getattr(m, a)) for k, (m, a) in mods.items()}


@dataclass
class Context:
    """What a metric reader reads."""
    setup_s: float
    records: list = None       # the measured window (--trace 0)
    trace: object = None       # the traced requests (--trace 1)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _card():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(cell, seed, seconds, trace, device, t_start, log=print):
    """Run the cell on ``device``; returns (result dict, check lines)."""
    import torch

    from . import check, sequences, window
    from . import trace as tracing
    from .traffic import Stream, call_arguments, resolve_entry, \
        warmup_requests

    tr, cfg = cell.traffic, cell.config
    entry = resolve_entry(tr)
    reference = load_module("references", tr["reference"]).reduce
    readers = {m["name"]: load_module("metrics", m["name"]).read
               for m in (cell.per_layer if trace else cell.end_to_end)}
    counters = counters_reader()

    t_imports = time.perf_counter() - t_start
    pool = sequences.make_pool(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_pool = time.perf_counter() - t_start
    stream = Stream(tr, seed, len(pool))

    def call(req):
        args, kwargs = call_arguments(tr, pool[req.member], req)
        return entry(*args, **kwargs)

    warm = []
    for req in warmup_requests(tr):
        rec = window.run_one(call, req)
        if rec.error:
            raise BenchError(f"warm-up request failed: {rec.error}")
        warm.append(rec.end - rec.start)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.4f} s: imports {t_imports:.4f} s, pool of "
        f"{len(pool)} {t_pool - t_imports:.4f} s, warm-up requests "
        + ", ".join(f"{w:.4f}" for w in warm) + f" s (seed {seed})",
        file=sys.stderr, flush=True)

    ctx = Context(setup_s)
    if trace:
        ctx.trace = tracing.profile_requests(
            lambda: window.run_one(call, stream.next()),
            tr["trace_requests"], tracing.Ranges(cell.layers), counters)
        records = [r.record for r in ctx.trace.requests]
        for i, r in enumerate(ctx.trace.requests):
            log(f"traced request {i}: {r.record.request.drawn} "
                f"{(r.end - r.start) / 1e9:.4f} s, launches {r.counters}",
                file=sys.stderr, flush=True)
        log(f"device events linked to their launch: {ctx.trace.linked}, "
            f"by device span: {ctx.trace.unlinked}", file=sys.stderr,
            flush=True)
        for m in cell.per_layer:
            if cell.layers[m["layer"]] and \
                    not ctx.trace.range_entered(m["layer"]):
                raise BenchError(f"no traced request entered the range of "
                                 f"layer {m['layer']!r} ({m['name']})")
    else:
        records = ctx.records = window.closed_loop(call, stream.next,
                                                   seconds=seconds)
        lat = np.asarray([r.end - r.start for r in records])
        log(f"window {window.window_seconds(records):.4f} s, "
            f"{len(records)} requests, latency quartiles "
            + ", ".join(f"{q:.4f}" for q in np.quantile(lat, [.25, .5, .75]))
            + f" s, max {lat.max():.4f} s", file=sys.stderr, flush=True)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = readers[m["name"]](ctx, m)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the comparison, once the program's state is freed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    idx = check.sample(records, tr["check"]["requests"], seed)
    gaps = check.reference_gaps(records, idx, pool, reference)
    correct, numbers = check.verdict(gaps, records, tr["check"]["limits"])
    log(f"compared requests {idx} of {len(records)}: frame_gap (program, "
        f"float32 witness) " + ", ".join(f"({p:.4e}, {w:.4e})"
                                         for p, w in gaps),
        file=sys.stderr, flush=True)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": sum(r.error is not None for r in records),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    result["checks"] = {k: {kk: "inf" if isinstance(vv, float)
                            and math.isinf(vv) else vv
                            for kk, vv in v.items()}
                        for k, v in numbers.items()}
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}"
             for k, v in numbers.items()]
    errors = [r.error for r in records if r.error]
    if errors:
        lines.insert(0, f"failed requests: {len(errors)}, first: "
                        f"{errors[0]}")
    return result, lines


def main(argv, t_start):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = load_cell(a.workload)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise BenchError(f"{a.workload} needs {cell.chips} CUDA card(s); "
                         f"{n} available")
    torch.set_num_threads(4)
    device = torch.device("cuda:0")
    print(f"card: {_card()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    result, lines = run_cell(cell, a.seed % (1 << 63), a.seconds, a.trace,
                             device, t_start)
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"modules loaded that the benchmark may not load: "
                         f"{', '.join(bad)}")
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False, default=_finite), flush=True)


def _finite(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    raise TypeError(type(v))

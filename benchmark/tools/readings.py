"""The readings that the limits of ``correct`` are set from, on the card,
at a cell's own sizes:

    python3 benchmark/tools/readings.py --workload NAME --seeds 1 2 3 ...

For each seed it makes the cell's pool, sends as many requests as a run
compares (the first of the seed's stream, one client, as the window sends
them), and reads ``frame_gap`` against the float64 reference of the
program, of the float32 witness and of the control (the reference itself
in TF32, the precision below the program's float32 with TF32 off), and
the compared number ``gap_vs_float32`` of the program and of the control.
The benchmark's own runs do not run the control. Prints one line a
request and a summary: the lower reading (the program's largest ratio)
and the upper one (the control's smallest).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(BENCH, ".cache",
                                                       "torch_kernels")
os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)
sys.path.insert(0, os.path.dirname(BENCH))
sys.path.insert(0, BENCH)

import torch  # noqa: E402

from yardstick import check, harness, sequences, window  # noqa: E402
from yardstick.traffic import (Stream, call_arguments,  # noqa: E402
                               resolve_entry)


def readings(cell, seeds, device, log=print):
    tr = cell.traffic
    entry = resolve_entry(tr)
    reference = harness.load_module("references", tr["reference"]).reduce
    count = tr["check"]["requests"]
    rows = []
    for seed in seeds:
        stream = Stream(tr, seed, cell.config["pool"])
        reqs = [stream.next() for _ in range(count)]
        members = sorted({r.member for r in reqs})
        pool = {m: sequences.make_sequence(cell.config, seed, m, device)
                for m in members}
        for req in reqs:
            seq = pool[req.member]
            args, kwargs = call_arguments(tr, seq, req)
            rec = window.run_one(lambda r: entry(*args, **kwargs), req)
            scale = check.input_scale(seq.cube)
            ref = reference(seq.cube, seq.angles, req.kwargs, "float64")
            gap = {"program": check.frame_gap(rec.frame, ref, scale)}
            for side in ("float32", "tf32"):
                t0 = time.perf_counter()
                out = reference(seq.cube, seq.angles, req.kwargs, side)
                gap[side] = check.frame_gap(
                    out.to(torch.float64).cpu().numpy(), ref, scale)
                gap[side + "_s"] = time.perf_counter() - t0
                del out
            row = {"seed": seed, "request": req.index, "drawn": req.drawn,
                   **gap, "program_s": rec.end - rec.start,
                   "program_ratio": gap["program"] / gap["float32"],
                   "control_ratio": gap["tf32"] / gap["float32"],
                   "error": rec.error}
            rows.append(row)
            log(json.dumps(row, default=str), flush=True)
            del ref
        del pool
        if device.type == "cuda":
            torch.cuda.empty_cache()
    lower = max(r["program_ratio"] for r in rows)
    upper = min(r["control_ratio"] for r in rows)
    log(f"SUMMARY {cell.name}: gap_vs_float32 of the program (lower) "
        f"{lower!r}, of the control (upper) {upper!r}, ratio "
        f"{upper / lower:.3g}; frame_gap of the program up to "
        f"{max(r['program'] for r in rows)!r}, of the control from "
        f"{min(r['tf32'] for r in rows)!r}", flush=True)
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("readings: no CUDA card")
    readings(harness.load_cell(a.workload), a.seeds, torch.device("cuda:0"))


if __name__ == "__main__":
    main()

"""The control fails: the plain reference put in the program's place and
computed in TF32 (the precision below the program's float32 with TF32
off) reads ``gap_vs_float32`` above each cell's limit, while the program
reads below it. On the CPU at a test's size; on the card at the cells'
own sizes (``benchmark/tools/readings.py`` gives the same readings for a
dozen seeds)."""

import pytest
import torch

from yardstick import check, harness, sequences
from yardstick.traffic import Stream, call_arguments, resolve_entry

from conftest import tiny

CELLS = ["adi512.pca_fullfr", "ifs290.pca_single", "ifs290.pca_double"]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


def _run_readings(cell, seed, device):
    """(program, control) gap_vs_float32 of one run's compared requests:
    the worst over them, as a run reads it."""
    tr = cell.traffic
    entry = resolve_entry(tr)
    ref_fn = harness.load_module("references", tr["reference"]).reduce
    stream = Stream(tr, seed, cell.config["pool"])
    pool = sequences.make_pool(cell.config, seed, device)
    prog, ctl = [], []
    for _ in range(tr["check"]["requests"]):
        req = stream.next()
        seq = pool[req.member]
        args, kwargs = call_arguments(tr, seq, req)
        frame = entry(*args, **kwargs).detach().cpu().numpy()
        scale = check.input_scale(seq.cube)
        ref = ref_fn(seq.cube, seq.angles, req.kwargs, "float64")
        gap = {p: check.frame_gap(
            ref_fn(seq.cube, seq.angles, req.kwargs, p).double().cpu()
            .numpy(), ref, scale) for p in ("float32", "tf32")}
        prog.append(check.frame_gap(frame, ref, scale) / gap["float32"])
        ctl.append(gap["tf32"] / gap["float32"])
    return max(prog), max(ctl)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_on_the_cpu(cell_name):
    cell = tiny(cell_name)
    if cell_name == "ifs290.pca_double":
        cell.traffic["draws"]["ncomp"]["tuple"][1]["int"] = [5, 8]
    limit = cell.traffic["check"]["limits"]["gap_vs_float32"]
    for seed in SEEDS:
        prog, ctl = _run_readings(cell, seed, torch.device("cpu"))
        assert ctl > limit, (seed, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_at_the_cells_size(cell_name, card):
    cell = harness.load_cell(cell_name)
    limit = cell.traffic["check"]["limits"]["gap_vs_float32"]
    for seed in SEEDS:
        prog, ctl = _run_readings(cell, seed, card)
        assert prog <= limit < ctl, (seed, prog, ctl)

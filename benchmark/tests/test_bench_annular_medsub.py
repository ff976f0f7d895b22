"""The two cells of annular PCA-ADI and median-ADI at a test's size on the
CPU: a sound run in float64 is correct; a run with its timed path broken
underneath (frames left unrotated, a collapse over half the frames, one
pixel off by 0.1%) is not; and the control (the plain reference in its
precision below float32) reads ``gap_vs_float32`` above the cell's
limit, on the CPU at the test's size and on the card at the cells' own
sizes (``-m cuda``). The annular cell runs 128 frames with the subspace
iteration forced, its own route at 512 frames."""

import importlib
import time

import pytest
import torch

from yardstick import harness

from conftest import tiny
from test_bench_control import SEEDS, _run_readings
from test_bench_faults import _altered, _half_batch, _unchanged

CELLS = ["adi256.pca_annular", "adi512.median_sub"]

FAULTS = {
    "adi256.pca_annular": {
        "state unchanged": ("vip_tpu_torch.ops.pipeline", "_derotate_frames",
                            _unchanged),
        "half of the batch": ("vip_tpu_torch.preproc.subsampling",
                              "collapse_jax", _half_batch),
        "answer altered": ("vip_tpu_torch.psfsub", "pca_annular", _altered),
    },
    "adi512.median_sub": {
        "state unchanged": ("vip_tpu_torch.psfsub.medsub", "cube_derotate",
                            _unchanged),
        "half of the batch": ("vip_tpu_torch.psfsub.medsub", "cube_collapse",
                              _half_batch),
        "answer altered": ("vip_tpu_torch.psfsub", "median_sub", _altered),
    },
}


@pytest.fixture(autouse=True)
def the_cells_route(monkeypatch):
    monkeypatch.setenv("VIP_TPU_ANNULAR_METHOD", "subspace")


def _cell(cell_name, **config):
    if cell_name == "adi256.pca_annular":
        config.setdefault("frames", 128)
    cell = tiny(cell_name, **config)
    cell.traffic["trace_requests"] = 2
    return cell


def _run(cell_name):
    return harness.run_cell(_cell(cell_name, dtype="float64"), 2 ** 31 + 77,
                            0.3, 0, torch.device("cpu"), time.perf_counter(),
                            log=lambda *a, **k: None)[0]


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    res = _run(cell_name)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["gap_vs_float32"]["value"] < 0.1, res["checks"]
    assert {"frames_per_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", ["state unchanged", "half of the batch",
                                   "answer altered"])
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_path_is_not_correct(cell_name, fault, monkeypatch):
    mod_name, attr, make = FAULTS[cell_name][fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res = _run(cell_name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_on_the_cpu(cell_name):
    cell = _cell(cell_name)
    limit = cell.traffic["check"]["limits"]["gap_vs_float32"]
    for seed in SEEDS:
        prog, ctl = _run_readings(cell, seed, torch.device("cpu"))
        assert prog <= limit < ctl, (seed, prog, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_at_the_cells_size(cell_name, card, monkeypatch):
    monkeypatch.delenv("VIP_TPU_ANNULAR_METHOD")
    cell = harness.load_cell(cell_name)
    limit = cell.traffic["check"]["limits"]["gap_vs_float32"]
    for seed in SEEDS:
        prog, ctl = _run_readings(cell, seed, card)
        assert prog <= limit < ctl, (seed, prog, ctl)

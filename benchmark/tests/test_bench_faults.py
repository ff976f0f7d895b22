"""A run with its timed path broken underneath comes out not correct: the
harness's look for a chip skipped, each cell at a test's size on the CPU,
the program in float64 (so that a sound run reads far below the limit),
once for each fault such a reduction can have. The cells run on one chip
and exchange nothing between chips, so there is no exchange to leave
out."""

import time

import pytest
import torch

from yardstick import harness

from conftest import tiny

CELLS = ["adi512.pca_fullfr", "ifs290.pca_single", "ifs290.pca_double"]


def _unchanged(orig):
    """A derotation that returns its frames as they came."""
    def derotate(array, angle_list, **kwargs):
        return array.clone()
    return derotate


def _half_batch(orig):
    """A collapse over the first half of the frames alone."""
    def collapse(cube, mode="median", w=None, **kwargs):
        return orig(cube[:cube.shape[0] // 2], mode=mode, w=w, **kwargs)
    return collapse


def _altered(orig):
    """The frame as the program returns it, one pixel off by 0.1% of the
    input's scale."""
    def pca(cube, *args, **kwargs):
        out = orig(cube, *args, **kwargs).clone()
        out[out.shape[0] // 3, out.shape[1] // 3] += 1e-3 * float(
            cube.abs().max())
        return out
    return pca


FAULTS = {
    "state unchanged": ("vip_tpu_torch.psfsub.pca_fullfr", "cube_derotate",
                        _unchanged),
    "half of the batch": ("vip_tpu_torch.psfsub.pca_fullfr", "cube_collapse",
                          _half_batch),
    "answer altered": ("vip_tpu_torch.psfsub", "pca", _altered),
}


def _run(cell_name, trace=0):
    cell = tiny(cell_name, dtype="float64")
    if cell_name == "ifs290.pca_double":
        cell.traffic["draws"]["ncomp"]["tuple"][1]["int"] = [5, 8]
    cell.traffic["trace_requests"] = 3
    return harness.run_cell(cell, 2 ** 31 + 77, 0.3, trace,
                            torch.device("cpu"), time.perf_counter(),
                            log=lambda *a, **k: None)[0]


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_run_is_correct(cell_name):
    res = _run(cell_name)
    assert res["correct"] and res["failed"] == 0
    # float64 lands far nearer the float64 reference than float32 does
    assert res["checks"]["gap_vs_float32"]["value"] < 0.1, res["checks"]
    assert {"frames_per_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_path_is_not_correct(cell_name, fault, monkeypatch):
    import importlib

    mod_name, attr, make = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res = _run(cell_name)
    assert not res["correct"], res["checks"]


def test_a_failing_request_is_not_correct(monkeypatch):
    import vip_tpu_torch.psfsub as psfsub

    def pca(cube, *args, **kwargs):
        raise RuntimeError("out of memory")
    monkeypatch.setattr(psfsub, "pca", pca)
    cell = tiny("adi512.pca_fullfr")
    cell.traffic["warmup"] = 0
    res = harness.run_cell(cell, 1, 0.1, 0, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a, **k: None)[0]
    assert not res["correct"] and res["failed"] == res["attempted"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_traced_run_enters_every_range(cell_name):
    res = _run(cell_name, trace=1)
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "breakdown" in res and list(res)[-1] == "checks"

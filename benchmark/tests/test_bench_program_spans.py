"""The readers of the program's spans (``program_spans.py``) on a
synthetic trace, and on traced runs of the three cells cut to the CPU:
the card's idle time split exactly at the spans' boundaries, each piece
put down to the innermost span open then, spans clipped to their request,
and None where a request lacks its one outermost ``api.pca`` span."""

import importlib
import time

import pytest
import torch

import program_spans
from conftest import tiny
from yardstick import harness
from yardstick.trace import Trace, TracedRequest

CELLS = ("adi512.pca_fullfr", "ifs290.pca_single", "ifs290.pca_double")
NEW = ("api_idle_ms", "derotation_idle_ms", "factorization_idle_ms",
       "rescaling_idle_ms", "factorizations_per_reduction")

# (name, start, end, parent, root, count): the second request's root
# opens before the request and closes after it
SPANS = [("api.pca", 5, 95, None, 0, 12),
         ("derotation.cube_derotate", 30, 70, 0, 0, 12),
         ("derotation.shear_setup", 30, 40, 1, 0, 12),
         ("factorization.eigh", 80, 90, 0, 0, 1),
         ("api.pca", 190, 310, None, 4, 12),
         ("factorization.svd", 250, 260, 4, 4, 100)]


def _trace():
    reqs = [TracedRequest(0, 100, device=[("k", 10, 20), ("k", 50, 60)]),
            TracedRequest(200, 300, device=[("k", 200, 300)])]
    return Trace(reqs, (0, 300), 120, [], [], 0, 0)


def test_idle_goes_to_the_innermost_span_of_its_request():
    split = program_spans.idle_by_layer(_trace(), SPANS)
    # idle: 0..10, 20..50, 60..100 in the first request, 100..200 between
    assert split == {None: 5 + 5 + 100, "api": 5 + 10 + 10 + 5,
                     "derotation": 10 + 10 + 10, "factorization": 10}
    t = _trace()
    assert abs(sum(split.values()) - (t.window[1] - t.window[0]
                                      - t.busy_ns)) <= 1_000


def test_innermost_segments():
    segs = program_spans.innermost_segments(
        [(0, 100, "a"), (0, 40, "b"), (10, 20, "c"), (40, 60, "d"),
         (120, 130, "e"), (125, 125, "empty")])
    assert segs == [(0, 10, "b"), (10, 20, "c"), (20, 40, "b"),
                    (40, 60, "d"), (60, 100, "a"), (120, 130, "e")]


@pytest.mark.parametrize("spans", [
    [s for s in SPANS if s[1] < 100],                       # no root
    SPANS + [("api.pca", 220, 230, None, 6, 1)],            # two roots
], ids=["missing", "two"])
def test_none_unless_one_root_a_request(spans):
    assert program_spans.idle_by_layer(_trace(), spans) is None
    assert program_spans.per_request(_trace(), spans) is None


def test_readers(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: SPANS)
    ctx = harness.Context(0.0, trace=_trace())
    got = {}
    for name in NEW:
        layer = name.split("_")[0]
        got[name] = harness.load_module("metrics", name).read(
            ctx, {"name": name, "layer": layer})
    assert got == {"api_idle_ms": 15e-6, "derotation_idle_ms": 15e-6,
                   "factorization_idle_ms": 5e-6, "rescaling_idle_ms": 0.0,
                   "factorizations_per_reduction": 50.5}


def test_a_program_without_spans_reads_none(monkeypatch):
    timing = importlib.import_module("vip_tpu_torch.config.timing")
    monkeypatch.delattr(timing, "spans")
    ctx = harness.Context(0.0, trace=_trace())
    for name in NEW:
        assert harness.load_module("metrics", name).read(
            ctx, {"name": name, "layer": name.split("_")[0]}) is None


def test_the_new_metrics_name_their_cells():
    spec = harness.load_json(harness.os.path.join(harness.ROOT,
                                                  "BENCHMARK.json"))
    per = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert per[name]["moves"] == "frames_per_s"
        assert per[name]["workloads"] == (
            ["ifs290.pca_single", "ifs290.pca_double"]
            if name == "rescaling_idle_ms" else list(CELLS))


# at the CPU's size the single pass's 390 x 1024 matrix is not tall enough
# for the QR: one SVD; each of the double pass's 10 + 1 takes both
@pytest.mark.parametrize("cell_name,matrices", [
    ("adi512.pca_fullfr", 1), ("ifs290.pca_single", 1),
    ("ifs290.pca_double", 2 * 10 + 2)])
def test_a_traced_run_reads_the_spans(cell_name, matrices):
    cell = tiny(cell_name, dtype="float64")
    cell.traffic["trace_requests"] = 2
    if cell_name == "ifs290.pca_double":
        cell.traffic["draws"]["ncomp"]["tuple"][1]["int"] = [5, 8]
    res = harness.run_cell(cell, 2 ** 31 + 19, 0.3, 1, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a, **k: None)[0]
    m = res["metrics"]
    names = {n for n in NEW if n != "rescaling_idle_ms"
             or cell_name != "adi512.pca_fullfr"}
    assert names <= set(m)
    assert m["factorizations_per_reduction"]["value"] == matrices
    # no card: the whole window is idle, most of it inside the spans
    idle = sum(m[n]["value"] for n in names if n.endswith("_idle_ms"))
    assert 0 < idle * 2 / 1e3 <= res["device"]["window_s"]

"""The reader of ``subspace_svd_matrices``
(``metrics/subspace_svd_matrices.py``) on a synthetic trace and on traced
runs of the three cells cut to the CPU: the counts of the program's
``factorization.svd_subspace`` spans a request, 0 where the route never
engages, None where a request lacks its one outermost ``api.pca`` span
or the program has no such route."""

import time

import pytest
import torch

import program_spans
from conftest import tiny
from yardstick import harness
from yardstick.trace import Trace, TracedRequest

NAME = "subspace_svd_matrices"
CELLS = ("adi512.pca_fullfr", "ifs290.pca_single", "ifs290.pca_double")

# (name, start, end, parent, root, count): each request's route span sits
# inside its SVD span, as ops.linalg.svd_subspace opens them; the second
# request's matrix fell back to gesvd (a count of 0)
SPANS = [("api.pca", 5, 95, None, 0, 12),
         ("factorization.qr", 60, 70, 0, 0, 1),
         ("factorization.svd", 80, 90, 0, 0, 1),
         ("factorization.svd_subspace", 81, 89, 2, 0, 1),
         ("api.pca", 190, 310, None, 4, 12),
         ("factorization.svd", 250, 260, 4, 4, 1),
         ("factorization.svd_subspace", 251, 259, 5, 4, 0)]


def _trace():
    reqs = [TracedRequest(0, 100, device=[("k", 10, 20)]),
            TracedRequest(200, 300, device=[("k", 200, 300)])]
    return Trace(reqs, (0, 300), 110, [], [], 0, 0)


def _reader():
    return harness.load_module("metrics", NAME)


def _read(trace):
    return _reader().read(harness.Context(0.0, trace=trace),
                          {"name": NAME, "layer": "factorization"})


@pytest.mark.parametrize("spans,want", [
    (SPANS, 0.5),                                    # 1 over 2 requests
    ([s for s in SPANS if s[0] != "factorization.svd_subspace"], 0.0),
    ([s for s in SPANS if s[1] < 100], None),        # second root missing
], ids=["counted", "none_routed", "missing_root"])
def test_reads_the_counts_of_the_route_spans(monkeypatch, spans, want):
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    assert _read(_trace()) == want


def test_a_program_without_the_route_reads_none(monkeypatch):
    from vip_tpu_torch.ops import linalg

    monkeypatch.setattr(program_spans, "recorded", lambda: SPANS)
    monkeypatch.delattr(linalg, "svd_subspace")
    assert _read(_trace()) is None


def test_the_metric_names_its_cells():
    spec = harness.load_json(harness.os.path.join(harness.ROOT,
                                                  "BENCHMARK.json"))
    per = {m["name"]: m for m in spec["per_layer"]}
    assert per[NAME] == {"name": NAME, "unit": "matrices",
                         "better": "higher", "source": "program_counter",
                         "layer": "factorization", "moves": "frames_per_s",
                         "workloads": list(CELLS)}


# on the CPU the route never engages (CPU tensors keep torch.linalg.svd):
# the metric reads 0 in every cell
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_traced_run_on_the_cpu_reads_zero(cell_name):
    cell = tiny(cell_name, dtype="float64")
    cell.traffic["trace_requests"] = 2
    if cell_name == "ifs290.pca_double":
        cell.traffic["draws"]["ncomp"]["tuple"][1]["int"] = [5, 8]
    res = harness.run_cell(cell, 2 ** 31 + 29, 0.3, 1, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a, **k: None)[0]
    assert res["metrics"][NAME]["value"] == 0

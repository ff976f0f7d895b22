"""The readers of requests rooted in any public entry point
(``request_spans.py``) on a synthetic trace, and on traced runs of the
annular cell cut to the CPU: with an ``api.pca`` root they split the
card's idle exactly as ``program_spans.py`` does; with an
``api.pca_annular`` root they put it down to the annular layer's spans;
and every new metric reads None where the program keeps no spans or the
requests lack their one outermost ``api.*`` span."""

import importlib
import time

import pytest
import torch

import program_spans
import request_spans
from conftest import tiny
from test_bench_program_spans import SPANS, _trace
from yardstick import harness

NEW = ("annular_idle_ms", "library_pcas_per_reduction")

# an annular request: libraries, segments and their factorizations, then
# the derotation; the second request holds two factorizations
ANNULAR = [("api.pca_annular", 5, 95, None, 0, 12),
           ("annular.libraries", 5, 15, 0, 0, 12),
           ("annular.segment", 15, 45, 0, 0, 300),
           ("annular.subspace", 25, 30, 2, 0, 12),
           ("derotation.frames", 60, 90, 0, 0, 12),
           ("api.pca_annular", 190, 310, None, 5, 12),
           ("annular.segment", 205, 240, 5, 5, 200),
           ("annular.eigh", 210, 215, 6, 5, 12),
           ("annular.svd", 220, 225, 6, 5, 12)]


def _read(name, ctx):
    return harness.load_module("metrics", name).read(
        ctx, {"name": name, "layer": "annular"})


def test_an_api_pca_root_splits_as_program_spans_does():
    assert request_spans.idle_by_layer(_trace(), SPANS) == \
        program_spans.idle_by_layer(_trace(), SPANS)
    assert request_spans.per_request(_trace(), SPANS) == \
        program_spans.per_request(_trace(), SPANS)


def test_idle_goes_to_the_annular_spans():
    split = request_spans.idle_by_layer(_trace(), ANNULAR)
    # device busy 10..20, 50..60 and 200..300; idle 0..10, 20..50,
    # 60..100 in the first request, 100..200 between the requests
    assert split == {None: 5 + 5 + 100, "api": 5 + 5,
                     "annular": 5 + 5 + 5 + 15, "derotation": 30}
    t = _trace()
    assert sum(split.values()) == t.window[1] - t.window[0] - t.busy_ns


def test_readers(monkeypatch):
    monkeypatch.setattr(program_spans, "recorded", lambda: ANNULAR)
    ctx = harness.Context(0.0, trace=_trace())
    assert _read("annular_idle_ms", ctx) == pytest.approx(15e-6)
    assert _read("library_pcas_per_reduction", ctx) == (12 + 12 + 12) / 2


@pytest.mark.parametrize("spans", [
    [s for s in ANNULAR if s[3] is not None],                  # no root
    ANNULAR + [("api.pca", 220, 230, None, 9, 1)],             # two roots
    [("derotation.shear_setup", 30, 40, None, 0, 12)],         # no api
], ids=["missing", "two", "a-program-without-annular-spans"])
def test_none_unless_one_api_root_a_request(spans, monkeypatch):
    assert request_spans.idle_by_layer(_trace(), spans) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    ctx = harness.Context(0.0, trace=_trace())
    for name in NEW:
        assert _read(name, ctx) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    timing = importlib.import_module("vip_tpu_torch.config.timing")
    monkeypatch.delattr(timing, "spans")
    ctx = harness.Context(0.0, trace=_trace())
    for name in NEW:
        assert _read(name, ctx) is None


def test_the_new_metrics_name_their_cell():
    spec = harness.load_json(harness.os.path.join(harness.ROOT,
                                                  "BENCHMARK.json"))
    per = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW + ("annular_ms", "annular_derotation_roofline"):
        assert per[name]["moves"] == "frames_per_s"
        assert per[name]["workloads"] == ["adi256.pca_annular"]


def test_a_traced_run_reads_the_annular_spans(monkeypatch):
    # the cell's route: the subspace iteration, forced below 512 frames
    monkeypatch.setenv("VIP_TPU_ANNULAR_METHOD", "subspace")
    cell = tiny("adi256.pca_annular", frames=128, dtype="float64")
    cell.traffic["trace_requests"] = 2
    res = harness.run_cell(cell, 2 ** 31 + 19, 0.3, 1, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a, **k: None)[0]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"], res["checks"]
    # 32 px frames: 4 annuli of one segment, 128 libraries each
    assert m["library_pcas_per_reduction"] == 128 * 4
    # no card: no device time in the ranges, every instant idle
    assert m["annular_ms"] == 0.0 and "annular_derotation_roofline" not in m
    assert 0 < m["annular_idle_ms"] * 2 / 1e3 <= res["device"]["window_s"]

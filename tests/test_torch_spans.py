"""The port's span recorder (``vip_tpu_torch.config.timing``) on the CPU.

- Outside the profiler nothing is recorded and every span is one shared
  no-op context.
- Under ``torch.profiler.profile`` spans nest with their parent, root and
  count, and the cap counts the spans it drops.
- The spans' clock is the profiler's: a span around a ``record_function``
  block holds that event's kineto interval.
- ``pca`` on tiny inputs of the benchmark's three traffic mixes (3-d Gram
  ADI, 4-d single pass, 4-d double pass): the span tree is ``api.pca`` over
  its layers, no profiler event carries a span's name (the spans are not
  ``record_function``), and every ``torch.linalg`` factorization runs in
  a ``factorization.qr/svd/eigh`` span that counts the matrices it
  factors.
- ``device_trace`` writes the spans into its Chrome trace file on the
  profiler's time base.
"""

import importlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import vip_tpu_torch
from vip_tpu_torch.psfsub import pca

timing = importlib.import_module("vip_tpu_torch.config.timing")

CPU = [ProfilerActivity.CPU]
CLOCK_NS = 50_000

RNG = np.random.default_rng(19)
ANGLES = np.linspace(0.0, 40.0, 12)
SCALES = np.array([1.2, 1.13, 1.07, 1.0])
CUBE3 = RNG.standard_normal((12, 32, 32))
CUBE4 = RNG.standard_normal((4, 6, 32, 32))

# (args, kwargs, span names, matrices factored) of each traffic mix
MIXES = {
    "adi": ((CUBE3, ANGLES), dict(ncomp=3, svd_mode="eigen",
                                  imlib="vip-fft", collapse="median"),
            {"api.pca", "factorization.project_subtract",
             "factorization.svd_top", "factorization.eigh",
             "derotation.cube_derotate", "collapse.cube_collapse"}, 1),
    "single": ((CUBE4, ANGLES[:6]), dict(scale_list=SCALES, ncomp=3,
                                          adimsdi="single", fwhm=2),
               {"api.pca", "rescaling.scwave",
                "factorization.project_subtract", "factorization.svd_top",
                "factorization.qr", "factorization.svd",
                "derotation.cube_derotate", "collapse.cube_collapse"}, 2),
    "double": ((CUBE4, ANGLES[:6]), dict(scale_list=SCALES, ncomp=(1, 2),
                                          adimsdi="double", fwhm=2),
               {"api.pca", "rescaling.scwave",
                "factorization.project_subtract", "factorization.svd_top",
                "factorization.qr", "factorization.svd",
                "derotation.cube_derotate", "collapse.cube_collapse"},
               2 * 6 + 2),
}


@pytest.fixture(autouse=True)
def fresh():
    vip_tpu_torch.set_device("cpu")
    timing.clear_spans()
    yield
    timing.clear_spans()


def _run(mix):
    args, kwargs, _, _ = MIXES[mix]
    return pca(*args, verbose=False, **kwargs)


def test_nothing_is_recorded_without_the_profiler():
    assert timing.annotate_trace("api.a", 1) is timing.annotate_trace("b.c")
    with timing.annotate_trace("api.outer", 3):
        _run("adi")
    assert timing.spans() == [] and timing.spans_dropped() == 0


def test_spans_nest_with_parent_root_and_count():
    @timing.traced("layer.fn", timing.leading_frames)
    def fn(x):
        with timing.annotate_trace("layer.inner", 7):
            return x

    with profile(activities=CPU):
        with timing.annotate_trace("api.outer", 1):
            fn(torch.zeros(2, 3, 4, 4))
            with timing.annotate_trace("layer.second"):
                pass
        with timing.annotate_trace("api.next"):
            pass
    got = timing.spans()
    assert [(n, p, r, c) for n, _, _, p, r, c in got] == [
        ("api.outer", None, 0, 1), ("layer.fn", 0, 0, 6),
        ("layer.inner", 1, 0, 7), ("layer.second", 0, 0, None),
        ("api.next", None, 4, None)]
    for _, s, e, parent, _, _ in got:
        assert s <= e
        if parent is not None:
            assert got[parent][1] <= s and e <= got[parent][2]


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(timing, "SPAN_CAP", 3)
    with profile(activities=CPU):
        with timing.annotate_trace("api.0"):
            for i in range(1, 5):
                with timing.annotate_trace(f"layer.{i}"):
                    pass
    assert [s[0] for s in timing.spans()] == ["api.0", "layer.1", "layer.2"]
    assert all(s[2] is not None for s in timing.spans())
    assert timing.spans_dropped() == 2
    timing.clear_spans()
    assert timing.spans() == [] and timing.spans_dropped() == 0


def test_spans_share_the_profilers_clock():
    with profile(activities=CPU) as prof:
        with timing.annotate_trace("api.clock"):
            with record_function("probe"):
                torch.ones(64).sum()
    (_, s, e, _, _, _), = timing.spans()
    ev, = [ev for ev in prof.profiler.kineto_results.events()
           if ev.name() == "probe"]
    assert s - CLOCK_NS <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= e + CLOCK_NS


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_pca_spans_and_factorizations(mix, monkeypatch):
    factored = []

    def logged(name, orig):
        def call(A, *args, **kwargs):
            open_ = [s for s in timing.spans() if s[2] is None]
            factored.append((name, A.shape[:-2].numel(),
                             open_[-1][0] if open_ else None,
                             open_[-1][5] if open_ else None))
            return orig(A, *args, **kwargs)
        return call

    for name in ("qr", "svd", "eigh"):
        monkeypatch.setattr(torch.linalg, name,
                            logged(name, getattr(torch.linalg, name)))
    _, _, names, matrices = MIXES[mix]
    with profile(activities=CPU) as prof:
        _run(mix)
    got = timing.spans()
    root, = [i for i, s in enumerate(got) if s[3] is None]
    assert got[root][0] == "api.pca"
    assert got[root][5] == int(np.prod(MIXES[mix][0][0].shape[:-2]))
    assert {s[0] for s in got} == names
    assert all(s[4] == root and s[2] is not None for s in got)
    assert all(got[s[3]][0].split(".")[0] in ("api", "factorization")
               for s in got if s[3] is not None)
    assert factored
    for name, n, span, count in factored:
        assert (span, count) == (f"factorization.{name}", n)
    assert sum(s[5] for s in got if s[0] in (
        "factorization.qr", "factorization.svd",
        "factorization.eigh")) == matrices
    kineto = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert not kineto & names


def test_device_trace_writes_the_spans_on_the_profilers_time_base(
        tmp_path):
    with profile(activities=CPU):
        with timing.annotate_trace("stale.span"):
            pass
    with timing.device_trace(str(tmp_path)) as tr:
        with timing.annotate_trace("api.block", 5):
            with record_function("probe"):
                torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    with open(tr.path) as fh:
        events = json.load(fh)["traceEvents"]
    span, = [e for e in events if e.get("cat") == "program_span"]
    probe, = [e for e in events if e.get("name") == "probe"]
    assert span["name"] == "api.block" and span["ph"] == "X"
    assert span["args"] == {"index": 0, "parent": None, "root": 0,
                            "count": 5}
    tol = CLOCK_NS / 1e3
    assert span["ts"] - tol <= probe["ts"]
    assert probe["ts"] + probe["dur"] <= span["ts"] + span["dur"] + tol
    assert not any(e.get("name") == "stale.span" for e in events)

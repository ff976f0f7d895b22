"""The reduction of the profiler's raw events: device work to requests
and to ranges by the launch that queued it, the device's busy union, and
the ranges wrapped around the program's bindings."""

import pytest
import torch

from yardstick import trace
from yardstick.window import Record

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, start, end, dev=CPU, corr=0, link=0):
        self._v = (name, start, end, dev, corr, link)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


EVENTS = [
    Ev("bench.request", 0, 100), Ev("bench.request", 200, 300),
    Ev("bench.derotation", 10, 50), Ev("aten::fft_c2c", 15, 45),
    Ev("cudaLaunchKernel", 20, 22, corr=7),
    Ev("shear_cols_kernel", 60, 90, CUDA, corr=7),
    Ev("bench.collapse", 55, 70), Ev("cudaLaunchKernel", 60, 61, corr=8),
    Ev("nanmedian_digits_kernel", 92, 95, CUDA, corr=8),
    Ev("cudaMemcpyAsync", 80, 99, corr=9),
    Ev("Memcpy DtoH (Device -> Pageable)", 96, 99, CUDA, corr=9),
    # a launch the trace lost: its kernel goes by the range's device span
    Ev("bench.factorization", 202, 260),
    Ev("bench.factorization", 205, 240, CUDA),
    Ev("gesvd_kernel", 210, 230, CUDA, corr=99),
]


def test_device_work_goes_to_its_request_and_range():
    recs = [Record(None, 0, 1), Record(None, 2, 3)]
    t = trace.reduce_events(EVENTS, recs, [[("derotation", None, None)],
                                           [("factorization", None, None)]],
                            [{}, {}])
    r1, r2 = t.requests
    assert len(r1.device) == 3 and len(r2.device) == 1
    assert r1.range_ns == {"derotation": 30, "collapse": 3}
    assert r2.range_ns == {"factorization": 20}
    assert (t.linked, t.unlinked) == (3, 1)
    assert t.window == (0, 300) and t.busy_ns == 30 + 3 + 3 + 20
    assert t.range_entered("derotation") and t.range_entered("factorization")
    assert not t.range_entered("rescaling")
    assert t.device_ops[0] == ["shear_cols_kernel", 30e-9]
    # gaps named by the innermost host span at their middle: 99..210
    # between the requests, 230..300 after the last kernel of the second,
    # 0..60 while the host ran the FFT op, 90..92 and 95..96 in a copy
    assert [[n, round(v * 1e9)] for n, v in t.idle_gaps] == [
        ["host (no traced call)", 111], ["bench.request", 70],
        ["aten::fft_c2c", 60], ["cudaMemcpyAsync", 3]]


def test_request_count_must_match():
    with pytest.raises(RuntimeError):
        trace.reduce_events(EVENTS, [Record(None, 0, 1)], [[]], [{}])


def test_innermost_span():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 70, "d")]
    got = trace.innermost(spans, [25, 5, 40, 65, 80, 120])
    assert [g and g[2] for g in got] == ["c", "a", "b", "d", "a", None]


def test_ranges_wrap_the_binding_of_the_calling_module():
    import vip_tpu_torch.psfsub.pca_fullfr as pf

    orig = pf.cube_collapse
    r = trace.Ranges({"collapse": [("vip_tpu_torch.psfsub.pca_fullfr",
                                    "cube_collapse")]})
    r.install()
    try:
        assert pf.cube_collapse is not orig
        out = pf.cube_collapse(torch.ones(4, 3, 3), mode="median")
    finally:
        r.remove()
    assert pf.cube_collapse is orig
    assert out.shape == (3, 3)
    assert r.calls == [("collapse", ((4, 3, 3), 4), ((3, 3), 4))]

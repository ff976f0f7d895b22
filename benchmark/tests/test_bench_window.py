"""The window's rate counts whole requests over the whole time."""

import numpy as np
import pytest

from yardstick import window
from yardstick.traffic import Request


class Clock:
    """A clock that a fake call advances."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _loop(durations, seconds, fail=()):
    clock, it = Clock(), iter(range(len(durations)))

    def call(req):
        clock.t += durations[req.index]
        if req.index in fail:
            raise RuntimeError("broken")
        return np.zeros((2, 2))

    def next_request():
        i = next(it)
        return Request(i, 0, {}, frames=10)

    return window.closed_loop(call, next_request, seconds=seconds,
                              clock=clock)


def test_the_window_closes_with_the_first_request_ending_after_seconds():
    recs = _loop([1.0, 1.0, 1.5, 1.0, 1.0], seconds=3.0)
    # ends at 1, 2, 3.5: the third request crosses 3 s and closes it
    assert len(recs) == 3
    assert window.window_seconds(recs) == pytest.approx(3.5)
    assert window.frames_per_s(recs) == pytest.approx(30 / 3.5)


def test_a_stall_stays_in_the_rate():
    recs = _loop([0.5, 4.0, 0.5, 0.5], seconds=1.0)
    assert len(recs) == 2
    assert window.frames_per_s(recs) == pytest.approx(20 / 4.5)


def test_failed_requests_count_as_attempted_not_as_frames():
    recs = _loop([1.0, 1.0, 1.0, 1.0], seconds=3.0, fail={1})
    assert len(recs) == 3 and recs[1].error and recs[1].frame is None
    assert window.frames_per_s(recs) == pytest.approx(20 / 3.0)


def test_the_tail_is_over_all_requests():
    recs = _loop([float(v) for v in range(1, 21)], seconds=200.0)
    assert len(recs) == 20
    lat = [r.end - r.start for r in recs]
    assert window.latency_quantile(recs, 0.95) == \
        pytest.approx(np.quantile(lat, 0.95))
    assert window.latency_quantile(recs, 0.95) == pytest.approx(19.05)

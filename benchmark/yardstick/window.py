"""The measured window: a closed loop of whole requests.

A request runs from the call into the program until its final frame is
in host memory as a numpy array. The window opens with the first request
and closes when the first request that ends after ``seconds`` ends, so no
request is cut in half and a stall anywhere stays in the rate.
"""

import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Record:
    request: object
    start: float
    end: float
    frame: object = None      # host numpy frame, None when the call failed
    error: str = None


def host_frame(out):
    """The final frame of a call's result, in host memory as numpy."""
    if isinstance(out, (tuple, list)):
        out = out[0]
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def run_one(call, request, clock=time.perf_counter):
    """One request through ``call(request)``; its record."""
    t0 = clock()
    try:
        frame = host_frame(call(request))
        err = None
    except Exception as exc:          # a failed request counts as failed
        frame, err = None, f"{type(exc).__name__}: {exc}"
    return Record(request, t0, clock(), frame, err)


def closed_loop(call, next_request, seconds=None, count=None,
                clock=time.perf_counter):
    """Send request after request until one ends after ``seconds`` or
    ``count`` have run. Returns the records."""
    records = []
    t_open = clock()
    while True:
        rec = run_one(call, next_request(), clock)
        records.append(rec)
        if seconds is not None and rec.end - t_open >= seconds:
            return records
        if count is not None and len(records) >= count:
            return records


def window_seconds(records):
    return records[-1].end - records[0].start


def frames_per_s(records):
    """Frames of every completed request over the whole window."""
    done = sum(r.request.frames for r in records if r.error is None)
    return done / window_seconds(records)


def latency_quantile(records, q):
    """The q-quantile (0..1) of the wall time of all requests in the
    window (numpy's linear interpolation)."""
    lat = [r.end - r.start for r in records]
    return float(np.quantile(np.asarray(lat), q))

"""Wall-clock timing, the profiler's trace, and the port's one span
recorder (port of ``vip_tpu.config.timing``).

A span is a named interval of host time at a layer boundary of the port
(``<layer>.<what>``: ``api.pca``, ``derotation.cube_derotate``,
``factorization.svd``...), opened by :func:`annotate_trace` (a ``with``
block) or :func:`traced` (a decorator). Spans are recorded only while
torch's profiler is enabled, so a run outside :class:`device_trace` or
``torch.profiler.profile`` pays one flag read a span. They are not
profiler events: ``record_function`` would put each span on the card's
timeline as a ``gpu_user_annotation`` too, where it reads as device
work. A span is a tuple ``(name, start_ns, end_ns, parent, root, count)``
kept in memory: both times from ``time.time_ns()``, the Unix-epoch clock
that the profiler's events carry; ``parent`` the index in :func:`spans`
of the enclosing span (None for an outermost one); ``root`` the index of
the outermost span, its own for an outermost one, so that every span of
one call shares it; ``count`` the work done at that boundary (frames,
matrices factored) or None. :class:`device_trace` writes them into its
Chrome trace file beside the profiler's events.
"""

import contextlib
import functools
import json
import math
import os
import socket
import threading
import time
from datetime import datetime

import torch
from torch.autograd import profiler as _profiler

from .utils_conf import sep

__all__ = ["time_ini", "timing", "time_fin", "device_trace",
           "annotate_trace"]

# spans kept at most; later ones are counted in spans_dropped()
SPAN_CAP = 1_000_000

_records = []        # [name, start_ns, end_ns, parent, root, count]
_dropped = 0
_lock = threading.Lock()
_open = threading.local()       # .stack: indices of this thread's open spans


def time_ini(verbose=True):
    """Set (and optionally print) the start time."""
    start_time = datetime.now()
    if verbose:
        print(sep)
        print("Starting time: " + start_time.strftime("%Y-%m-%d %H:%M:%S"))
        print(sep)
    return start_time


def timing(start_time):
    """Print elapsed time since ``start_time``."""
    print("Running time:  " + str(datetime.now() - start_time))
    print(sep)


def time_fin(start_time):
    """Return elapsed time since ``start_time`` as a string."""
    return str(datetime.now() - start_time)


class _Span:
    """One span while it is open; its record is in ``_records`` from the
    start on, its end written when it closes."""

    __slots__ = ("_name", "_count", "_rec", "_stack")

    def __init__(self, name, count):
        self._name, self._count, self._rec = name, count, None

    def __enter__(self):
        global _dropped
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        with _lock:
            if len(_records) >= SPAN_CAP:
                _dropped += 1
                return self
            i = len(_records)
            self._rec = [self._name, time.time_ns(), None,
                         stack[-1] if stack else None,
                         stack[0] if stack else i, self._count]
            _records.append(self._rec)
        stack.append(i)
        self._stack = stack
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec[2] = time.time_ns()
            self._stack.pop()
        return False

    def set_count(self, count):
        """Set the span's count, where it is known only inside the
        span."""
        if self._rec is not None:
            self._rec[5] = count


# every span while the profiler is off
_OFF = contextlib.nullcontext()


def annotate_trace(name, count=None):
    """A span named ``name`` (``<layer>.<what>``) around a ``with`` block,
    recorded while torch's profiler is enabled, with ``count``, the work
    done at that boundary (vip_tpu's ``jax.profiler.TraceAnnotation``).
    Outside the profiler it returns a shared no-op context. ``with ... as
    span`` gives the span, whose ``set_count`` sets a count known only
    inside the block, or None outside the profiler."""
    if _profiler._is_profiler_enabled:
        return _Span(name, count)
    return _OFF


def traced(name, count=None):
    """Decorator: each call of the function is a span named ``name``.
    ``count``, if given, is called with the call's arguments, only while
    the span is recorded, and gives the span's count."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, None if count is None
                       else count(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return wrap


def leading_frames(*args, **kwargs):
    """A span count: the frames of the call's first positional argument, a
    [..., y, x] stack (the product of its leading dimensions), or None."""
    shape = getattr(args[0], "shape", None) if args else None
    return None if shape is None else math.prod(shape[:-2])


def spans():
    """The spans recorded since the last :func:`clear_spans`, in the order
    they opened: ``(name, start_ns, end_ns, parent, root, count)`` tuples,
    ``end_ns`` None while a span is open."""
    with _lock:
        return [tuple(r) for r in _records]


def spans_dropped():
    """Spans not recorded since the last :func:`clear_spans` because
    ``SPAN_CAP`` spans were kept."""
    return _dropped


def clear_spans():
    """Forget every recorded span and the count of dropped ones. Spans
    still open then keep their place in no list."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def _write_spans(path, recorded):
    """Add ``recorded`` spans to the Chrome trace file ``path`` as
    complete events on its time base (``baseTimeNanoseconds``, when the
    file has one, and microseconds), on a track of their own."""
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "vip_tpu_torch spans"}})
    for i, (name, t0, t1, parent, root, count) in enumerate(recorded):
        if t1 is None:
            continue
        events.append({"ph": "X", "cat": "program_span", "name": name,
                       "pid": pid, "tid": 0, "ts": (t0 - base) / 1e3,
                       "dur": (t1 - t0) / 1e3,
                       "args": {"index": i, "parent": parent, "root": root,
                                "count": count}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


class device_trace:
    """Profile a block with ``torch.profiler`` and write its trace to
    ``log_dir`` (vip_tpu timing.py:32 wraps ``jax.profiler``)::

        with device_trace("vip-trace") as tr:
            pca(cube, angs, ncomp=10)
        print(tr.profile.key_averages().table(sort_by="cuda_time_total"))

    The profiler records the host's operators, and the card's kernels when
    PyTorch has CUDA; the trace is Chrome trace JSON
    (``<host>_<pid>.<time>.pt.trace.json``, its name in ``path``), which
    TensorBoard and the Perfetto UI open. The block's spans
    (:func:`annotate_trace`) are cleared on entry and written into the
    file on exit, on a track of their own. ``create_perfetto_link`` is
    kept for vip_tpu's signature and changes nothing: no link is made.
    ``profile`` is the ``torch.profiler.profile`` of the block."""

    def __init__(self, log_dir, create_perfetto_link=False):
        self.log_dir = log_dir
        self.create_perfetto_link = create_perfetto_link
        self.profile = None
        self.path = None

    def _ready(self, prof):
        os.makedirs(str(self.log_dir), exist_ok=True)
        self.path = os.path.join(
            str(self.log_dir), f"{socket.gethostname()}_{os.getpid()}."
                               f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(self.path)
        _write_spans(self.path, spans())

    def __enter__(self):
        clear_spans()
        self.profile = torch.profiler.profile(on_trace_ready=self._ready)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        self.profile.__exit__(*exc)
        return False

"""The traced run: ranges around the program's layer functions, the
profiler over a few requests, and the reduction of its raw events.

Ranges are opened from the benchmark's own files: a layer file
(``benchmark/layers/<layer>.json``) lists "module:attribute" names, and
each attribute is replaced, in that module's namespace, by a wrapper that
runs it inside ``torch.profiler.record_function("bench.<layer>")`` and
logs the shapes of its first tensor argument and result. A module that
imports a function by name has its own binding, so a layer file names
the binding in the module that calls it.

The events are read from the profiler's raw kineto list (no Python event
tree): a device event (kernel, copy or memset) belongs to the request and
to the innermost range whose host interval holds the call that launched
it, found by the correlation id of its launch; device events whose launch
is not in the list fall back to the device-side span of the range.
"""

import bisect
import functools
import importlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch

REQUEST = "bench.request"


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _shape(x):
    t = _first_tensor(x)
    return None if t is None else (tuple(t.shape), t.element_size())


class Ranges:
    """The wrappers of every layer file, installed and removed as one."""

    def __init__(self, layers):
        self.layers = layers          # {layer: [(module, attribute), ...]}
        self.calls = []               # (layer, (shape, itemsize) in, out)
        self._saved = []

    def _wrap(self, fn, layer):
        name = "bench." + layer

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                out = fn(*args, **kwargs)
            self.calls.append((layer, _shape(args[:1] or list(
                kwargs.values())), _shape(out)))
            return out
        return wrapped

    def install(self):
        for layer, names in self.layers.items():
            for mod_name, attr in names:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)     # a missing name is an error
                self._saved.append((mod, attr, orig))
                setattr(mod, attr, self._wrap(orig, layer))

    def remove(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []


@dataclass
class TracedRequest:
    start: int                                  # ns, host clock
    end: int
    device: list = field(default_factory=list)  # (name, start, end) ns
    range_ns: dict = field(default_factory=lambda: defaultdict(int))
    entered: set = field(default_factory=set)
    calls: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    record: object = None


@dataclass
class Trace:
    requests: list
    window: tuple              # (start, end) ns of the traced requests
    busy_ns: int               # union of device intervals in the window
    device_ops: list           # [(name, seconds)], most first
    idle_gaps: list            # [(what the host did, seconds)], most first
    linked: int                # device events found through their launch
    unlinked: int

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self):
        return self.busy_ns / 1e9

    def range_entered(self, layer):
        return any(layer in r.entered for r in self.requests)


def _is_launch(name):
    """A CUDA runtime or driver call (cudaLaunchKernel, cudaMemcpyAsync,
    cuLaunchKernel, ...), whose correlation id its device work carries."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _union(intervals, lo, hi):
    """Total length of the union of [s, e) intervals clipped to [lo, hi),
    and the gaps between them, as (start, end) pairs."""
    total, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            total += e - max(s, cur)
            cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return total, gaps


def innermost(spans, points):
    """For each time in ``points``, the innermost (start, end, name) of
    ``spans`` that holds it, or None: a sweep over both in time order with
    a stack of the spans still open (spans of one thread nest)."""
    spans = sorted(spans)
    order = sorted(range(len(points)), key=points.__getitem__)
    out, stack, j = [None] * len(points), [], 0
    for i in order:
        t = points[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def reduce_events(events, records, calls_by_request, counters_by_request,
                  top=10):
    """The Trace of the raw kineto ``events`` of the traced requests."""
    annotations, host_spans, launches, device, gpu_ann = [], [], {}, [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in events:
        name, s, d = ev.name(), ev.start_ns(), ev.duration_ns()
        if ev.device_type() == cuda:
            if name.startswith("bench."):
                gpu_ann.append((s, s + d, name[6:]))
            else:             # kernels, copies, memsets
                device.append((name, s, s + d, ev.correlation_id(),
                               ev.linked_correlation_id()))
            continue
        if name.startswith("bench."):
            annotations.append((s, s + d, name))
        elif _is_launch(name):
            launches[ev.correlation_id()] = s
        host_spans.append((s, s + d, name))

    req_spans = sorted((s, e) for s, e, n in annotations if n == REQUEST)
    if len(req_spans) != len(records):
        raise RuntimeError(f"the trace holds {len(req_spans)} request "
                           f"ranges for {len(records)} traced requests")
    reqs = [TracedRequest(s, e, calls=c, counters=k, record=r)
            for (s, e), c, k, r in zip(req_spans, calls_by_request,
                                       counters_by_request, records)]
    starts = [r.start for r in reqs]
    layer_spans = [(s, e, n[6:]) for s, e, n in annotations if n != REQUEST]

    linked = unlinked = 0
    layer_pts, ann_pts, owners = [], [], []
    for name, s, e, corr, link in device:
        t = launches.get(corr, launches.get(link))
        by_device = t is None
        if by_device:
            unlinked += 1
            t = s
        else:
            linked += 1
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > reqs[i].end:
            continue
        reqs[i].device.append((name, s, e))
        owners.append((reqs[i], e - s, by_device))
        (ann_pts if by_device else layer_pts).append(t)
    hits_layer = iter(innermost(layer_spans, layer_pts))
    hits_ann = iter(innermost(gpu_ann, ann_pts))
    for req, dur, by_device in owners:
        hit = next(hits_ann) if by_device else next(hits_layer)
        if hit is not None:
            req.range_ns[hit[2]] += dur
    for req in reqs:
        for layer, _, _ in req.calls:
            req.entered.add(layer)

    lo, hi = reqs[0].start, reqs[-1].end
    busy, gaps = _union([(s, e) for r in reqs for _, s, e in r.device],
                        lo, hi)
    per_op = defaultdict(int)
    for r in reqs:
        for name, s, e in r.device:
            per_op[name] += e - s
    per_gap = defaultdict(int)
    labels = innermost(host_spans, [(g0 + g1) // 2 for g0, g1 in gaps])
    for (g0, g1), hit in zip(gaps, labels):
        per_gap[hit[2] if hit else "host (no traced call)"] += g1 - g0
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(per_gap.items(), key=lambda kv: -kv[1])[:top]
    return Trace(reqs, (lo, hi), busy,
                 [[n, v / 1e9] for n, v in ops],
                 [[n, v / 1e9] for n, v in idle], linked, unlinked)


def profile_requests(run_one, n_requests, ranges, counters):
    """Run ``n_requests`` requests through ``run_one()`` (which returns a
    window Record) under the profiler, each inside a request range, with
    the layer ranges installed. ``counters()`` reads the program's launch
    counters; each request's are the difference across it. Returns the
    Trace."""
    from torch.profiler import ProfilerActivity, profile

    records, calls, counts = [], [], []
    ranges.install()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_requests):
                before_calls, before = len(ranges.calls), counters()
                with torch.profiler.record_function(REQUEST):
                    rec = run_one()
                after = counters()
                records.append(rec)
                calls.append(ranges.calls[before_calls:])
                counts.append({k: after[k] - before[k] for k in after})
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        ranges.remove()
    events = prof.profiler.kineto_results.events()
    return reduce_events(events, records, calls, counts)

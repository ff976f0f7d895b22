"""The program's own spans in a traced run, for the readers of the
``program_span`` and ``program_counter`` metrics.

The port records a span at each layer boundary while the profiler is on
(``vip_tpu_torch.config.timing.spans()``): ``(name, start_ns, end_ns,
parent, root, count)``, named ``<layer>.<what>``, on the Unix-epoch clock
that the profiler's events carry. They are not profiler events, so they
change nothing of what ``yardstick/trace.py`` reduces.

The card's idle time in a traced request is put down to the innermost
span open at each instant of it: the request's idle intervals (its span
less the union of its device intervals) are split exactly at the
boundaries of its spans, clipped to the request. Idle outside every span
(between requests, the copy out of ``pca``) is put down to no layer.
A program that keeps no spans (one without the recorder) reads None.
"""

import importlib

from yardstick.trace import _union

ROOT = "api.pca"
FACTORIZATIONS = ("factorization.qr", "factorization.svd",
                  "factorization.eigh")


def recorded():
    """The program's spans, or None where the program keeps none."""
    try:
        timing = importlib.import_module("vip_tpu_torch.config.timing")
    except ImportError:
        return None
    spans = getattr(timing, "spans", None)
    return None if spans is None else spans()


def _overlapping(req, spans):
    """The closed spans overlapping the request, as (start, end, name,
    parent, count) clipped to it."""
    return [(max(s, req.start), min(e, req.end), name, parent, count)
            for name, s, e, parent, _, count in spans
            if e is not None and s < req.end and e > req.start]


def per_request(trace, spans):
    """For each traced request, its clipped spans; None unless every
    request holds exactly one outermost ``api.pca`` span."""
    if trace is None or not trace.requests or spans is None:
        return None
    out = []
    for req in trace.requests:
        mine = _overlapping(req, spans)
        if sum(1 for _, _, name, parent, _ in mine
               if name == ROOT and parent is None) != 1:
            return None
        out.append(mine)
    return out


def innermost_segments(spans):
    """Split the union of nested ``(start, end, label, ...)`` spans into
    ``[(a, b, label)]``: disjoint, in time order, each labelled with the
    innermost span open on all of [a, b)."""
    spans = sorted((s for s in spans if s[1] > s[0]),
                   key=lambda s: (s[0], -s[1]))
    bounds = sorted({t for s in spans for t in s[:2]})
    out, stack, j = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while stack and stack[-1][1] <= a:
            stack.pop()
        while j < len(spans) and spans[j][0] <= a:
            stack.append(spans[j])
            j += 1
        if stack:
            out.append((a, b, stack[-1][2]))
    return out


def _layer(name):
    return name.split(".", 1)[0]


def _cover(segs, lo, hi):
    """``segs`` with the holes of [lo, hi) between them labelled None."""
    out, cur = [], lo
    for a, b, label in segs:
        if a > cur:
            out.append((cur, a, None))
        out.append((a, b, label))
        cur = b
    if cur < hi:
        out.append((cur, hi, None))
    return out


def idle_by_layer(trace, spans):
    """Nanoseconds of the traced window in which the card is idle, by the
    layer of the innermost program span open then (None: no span), or
    None where the requests' spans are not whole (``per_request``)."""
    clipped = per_request(trace, spans)
    if clipped is None:
        return None
    lo, hi = trace.window
    _, gaps = _union([(s, e) for r in trace.requests
                      for _, s, e in r.device], lo, hi)
    segs = _cover([seg for mine in clipped
                   for seg in innermost_segments(mine)], lo, hi)
    out, i, j = {None: 0}, 0, 0
    while i < len(segs) and j < len(gaps):
        (a, b, name), (g0, g1) = segs[i], gaps[j]
        if min(b, g1) > max(a, g0):
            key = None if name is None else _layer(name)
            out[key] = out.get(key, 0) + min(b, g1) - max(a, g0)
        if b < g1:
            i += 1
        else:
            j += 1
    return out


def layer_idle_ms(ctx, layer):
    """Device-idle ms a traced request under the innermost spans of
    ``layer``."""
    split = idle_by_layer(ctx.trace, recorded())
    if split is None:
        return None
    return split.get(layer, 0) / 1e6 / len(ctx.trace.requests)


def factorizations_per_request(ctx):
    """Matrices factored a traced request: the counts of the
    ``factorization.qr/svd/eigh`` spans."""
    clipped = per_request(ctx.trace, recorded())
    if clipped is None:
        return None
    n = sum(count or 0 for mine in clipped
            for _, _, name, _, count in mine if name in FACTORIZATIONS)
    return n / len(ctx.trace.requests)

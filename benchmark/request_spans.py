"""The program's own spans in a traced run, for requests rooted in any
public entry point of the program.

``program_spans.py`` reads requests whose root is ``api.pca``. Here a
request's root is its one outermost ``api.*`` span (``api.pca``,
``api.pca_annular``, ...): each such span is handed to ``program_spans``
under the name ``api.pca``, which changes no span's layer, and
``program_spans`` splits the card's idle and clips the spans as it does
for ``pca``. A program that keeps no spans, or whose requests do not each
hold one outermost ``api.*`` span, reads None.
"""

import program_spans

ROOT = program_spans.ROOT


def as_roots(spans):
    """``spans`` with every outermost ``api.*`` span named ``api.pca``."""
    if spans is None:
        return None
    return [(ROOT if parent is None and name.startswith("api.") else name,
             s, e, parent, root, count)
            for name, s, e, parent, root, count in spans]


def per_request(trace, spans):
    """For each traced request, its clipped spans ``(start, end, name,
    parent, count)``; None unless every request holds exactly one
    outermost ``api.*`` span."""
    return program_spans.per_request(trace, as_roots(spans))


def idle_by_layer(trace, spans):
    """Nanoseconds of the traced window in which the card is idle, by the
    layer of the innermost span open then (None: no span), or None where
    the requests' spans are not whole."""
    return program_spans.idle_by_layer(trace, as_roots(spans))


def layer_idle_ms(ctx, layer):
    """Device-idle ms a traced request under the innermost spans of
    ``layer``."""
    split = idle_by_layer(ctx.trace, program_spans.recorded())
    if split is None:
        return None
    return split.get(layer, 0) / 1e6 / len(ctx.trace.requests)


def count_per_request(ctx, names):
    """The counts of the spans named in ``names``, summed over the traced
    requests, a request; None where the requests' spans are not whole."""
    clipped = per_request(ctx.trace, program_spans.recorded())
    if clipped is None:
        return None
    n = sum(count or 0 for mine in clipped
            for _, _, name, _, count in mine if name in names)
    return n / len(ctx.trace.requests)

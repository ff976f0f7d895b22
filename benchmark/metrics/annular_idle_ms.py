"""annular_idle_ms: ms a traced request in which the card is idle while
the innermost span the program keeps is of the annular layer,
``annular.*``: the library masks and index arrays, the segment updates
and the library factorizations. From the program's spans
(``benchmark/request_spans.py``); None unless every traced request holds
one outermost ``api.*`` span."""

from request_spans import layer_idle_ms


def read(ctx, metric):
    return layer_idle_ms(ctx, metric["layer"])

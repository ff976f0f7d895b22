"""api_idle_ms: ms a traced request in which the card is idle while the
innermost span the program keeps is of the api layer, ``api.*``: ``pca``'s
own code (its parameter plumbing, the 4-d paths' glue) outside the spans
of its layers. From the program's spans (``benchmark/program_spans.py``);
None unless every traced request holds one outermost ``api.pca`` span."""

from program_spans import layer_idle_ms


def read(ctx, metric):
    return layer_idle_ms(ctx, metric["layer"])

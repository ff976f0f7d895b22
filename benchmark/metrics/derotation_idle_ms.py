"""derotation_idle_ms: ms a traced request in which the card is idle while
the innermost span the program keeps is of the derotation layer,
``derotation.*``: ``cube_derotate``, and H2's host set-up
(``derotation.shear_setup``). From the program's spans
(``benchmark/program_spans.py``); None unless every traced request holds
one outermost ``api.pca`` span."""

from program_spans import layer_idle_ms


def read(ctx, metric):
    return layer_idle_ms(ctx, metric["layer"])

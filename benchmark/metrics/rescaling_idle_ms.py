"""rescaling_idle_ms: ms a traced request in which the card is idle while the
innermost span the program keeps is of the rescaling layer,
``rescaling.*``: ``_scwave``, the spectral zooms and the channel collapse.
From the program's spans (``benchmark/program_spans.py``); None unless
every traced request holds one outermost ``api.pca`` span."""

from program_spans import layer_idle_ms


def read(ctx, metric):
    return layer_idle_ms(ctx, metric["layer"])

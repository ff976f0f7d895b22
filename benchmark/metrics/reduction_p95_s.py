"""reduction_p95_s: the 95th percentile of the wall time of all requests
in the window, from the call into the program until the final frame is in
host memory as numpy."""

from yardstick.window import latency_quantile


def read(ctx, metric):
    return latency_quantile(ctx.records, 0.95) if ctx.records else None

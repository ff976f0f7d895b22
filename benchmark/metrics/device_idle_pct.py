"""device_idle_pct: 100 x (1 - the union of the card's activity (kernels,
copies, memsets) / the wall time from the first traced request's start to
the last one's end)."""


def read(ctx, metric):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

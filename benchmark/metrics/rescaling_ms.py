"""rescaling_ms: device ms per request of the kernels launched inside the
range of the rescaling layer (the spectral rescaling of an IFS cube, both
ways, with its channel collapse)."""


def read(ctx, metric):
    t = ctx.trace
    if t is None or not t.range_entered(metric["layer"]):
        return None
    ns = sum(r.range_ns.get(metric["layer"], 0) for r in t.requests)
    return ns / 1e6 / len(t.requests)

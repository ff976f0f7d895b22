"""kernels_per_reduction: the kernels, copies and memsets on the card in
the traced requests over the number of requests. An exact count."""


def read(ctx, metric):
    t = ctx.trace
    if t is None or not t.requests:
        return None
    return sum(len(r.device) for r in t.requests) / len(t.requests)

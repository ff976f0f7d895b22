"""collapse_roofline: the bytes of every collapse in the traced
requests (its input read once, its output written once) over 3.35 TB/s,
over the device time of the kernels launched inside the collapse range."""

import math

from yardstick.roofline import bound_s, collapse_bytes


def read(ctx, metric):
    t = ctx.trace
    layer = metric["layer"]
    if t is None or not t.range_entered(layer):
        return None
    least = 0.0
    for r in t.requests:
        for _, (shape_in, size_in), (shape_out, _) in (
                c for c in r.calls if c[0] == layer):
            least += bound_s(collapse_bytes(math.prod(shape_in),
                                            math.prod(shape_out), size_in),
                             0.0)
    ns = sum(r.range_ns.get(layer, 0) for r in t.requests)
    return 100.0 * least / (ns / 1e9) if ns else None

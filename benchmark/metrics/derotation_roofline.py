"""derotation_roofline: the least time the chip needs for VIP's exact
three-shear rotation of the frames each derotation call was given (the
larger of bytes over 3.35 TB/s and float32 operations over 67 TFLOP/s,
yardstick.roofline) over the device time of the kernels launched inside
the derotation range. The work depends only on the frames' number and
size, whatever implements the rotation."""

from yardstick.roofline import bound_s, derotation_work


def read(ctx, metric):
    t = ctx.trace
    layer = metric["layer"]
    if t is None or not t.range_entered(layer):
        return None
    least = 0.0
    for r in t.requests:
        for name, (shape, _), _ in (c for c in r.calls if c[0] == layer):
            n, y, x = shape
            least += bound_s(*derotation_work(n, y))
    ns = sum(r.range_ns.get(layer, 0) for r in t.requests)
    return 100.0 * least / (ns / 1e9) if ns else None

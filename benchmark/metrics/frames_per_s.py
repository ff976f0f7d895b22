"""frames_per_s: the input frames of every request completed in the
window over the whole window (a 4-d frame counts once per channel)."""

from yardstick.window import frames_per_s


def read(ctx, metric):
    return frames_per_s(ctx.records) if ctx.records else None

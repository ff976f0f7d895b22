"""setup_s: seconds from the start of the process to the opening of the
window: imports, the CUDA context, the kernels' library (built on the
first run of a checkout), the pool of sequences, the warm-up requests."""


def read(ctx, metric):
    return ctx.setup_s

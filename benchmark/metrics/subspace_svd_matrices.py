"""subspace_svd_matrices: matrices a traced request factored on the
program's top-ncomp SVD route for large R factors (``ops.linalg.
svd_subspace``, which ``svd_top``'s 'lapack' branch takes for CUDA
float32 matrices of at least ``SUBSPACE_SVD_MIN_SIDE`` rows), the sum of
the counts of its ``factorization.svd_subspace`` spans over the requests:
the matrices it returned converged, not those that fell back to gesvd.
An exact count: 0 where the requests factor nothing on that route. None
for a program without the route, and unless every traced request holds
one outermost ``api.pca`` span."""

import importlib

from program_spans import per_request, recorded

SPAN = "factorization.svd_subspace"


def _has_route():
    try:
        linalg = importlib.import_module("vip_tpu_torch.ops.linalg")
    except ImportError:
        return False
    return hasattr(linalg, "svd_subspace")


def read(ctx, metric):
    if not _has_route():
        return None
    clipped = per_request(ctx.trace, recorded())
    if clipped is None:
        return None
    n = sum(count or 0 for mine in clipped
            for _, _, name, _, count in mine if name == SPAN)
    return n / len(ctx.trace.requests)

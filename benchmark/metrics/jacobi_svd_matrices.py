"""jacobi_svd_matrices: matrices a traced request factored by the program's
batched Jacobi SVD kernel (K5, the route of ``ops.linalg.svd`` for CUDA
float32 matrices of sides <= 64), the sum of the counts of its
``factorization.svd_jacobi`` spans over the requests. An exact count: 0
where the requests factor nothing on that route, as on a program without
it. None unless every traced request holds one outermost ``api.pca``
span."""

from program_spans import per_request, recorded

SPAN = "factorization.svd_jacobi"


def read(ctx, metric):
    clipped = per_request(ctx.trace, recorded())
    if clipped is None:
        return None
    n = sum(count or 0 for mine in clipped
            for _, _, name, _, count in mine if name == SPAN)
    return n / len(ctx.trace.requests)

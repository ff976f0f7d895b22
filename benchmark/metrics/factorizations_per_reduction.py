"""factorizations_per_reduction: matrices factored a traced request, the
sum of the counts of the program's ``factorization.qr``, ``.svd`` and
``.eigh`` spans (each the number of matrices one ``torch.linalg`` call of
``ops.linalg`` factors) over the requests. An exact count; None unless
every traced request holds one outermost ``api.pca`` span."""

from program_spans import factorizations_per_request


def read(ctx, metric):
    return factorizations_per_request(ctx)

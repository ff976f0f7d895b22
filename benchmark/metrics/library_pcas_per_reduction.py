"""library_pcas_per_reduction: the frames' libraries factored a traced
request, the sum of the counts of the program's ``annular.subspace``,
``annular.eigh`` and ``annular.svd`` spans (each the number of libraries
one factorization covers) over the requests. An exact count, whatever
route factors them; which of the spans holds it says which route ran.
None unless every traced request holds one outermost ``api.*`` span."""

from request_spans import count_per_request

SPANS = ("annular.subspace", "annular.eigh", "annular.svd")


def read(ctx, metric):
    return count_per_request(ctx, SPANS)

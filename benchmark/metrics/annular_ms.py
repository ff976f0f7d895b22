"""annular_ms: device ms per request of the kernels launched inside the
range of the annular layer: the segment updates of the resident annular
PCA (the segments' gathers, their Grams, the frames' library Grams and
their factorizations, the reconstructions and the residual scatters).
Read as ``factorization_ms`` reads its own range."""

from yardstick.harness import load_module

read = load_module("metrics", "factorization_ms").read

"""Device cores: linear algebra, FFT rotation, the CUDA kernels' wrappers
(``median``: H1, ``shear``: H2) and the end-to-end pipelines."""

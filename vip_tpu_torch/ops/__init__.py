"""Device cores: linear algebra, FFT rotation and shifts, the CUDA
kernels' wrappers (``median``: H1, ``shear``: H2, H3, H4), the injection
of companion ladders and the end-to-end pipelines."""

"""Device ops: the FM interaction and its CUDA kernels."""

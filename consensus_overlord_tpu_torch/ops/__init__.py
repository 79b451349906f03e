"""Device arithmetic: field, Fq2, curves, BLS12-381 groups, CUDA kernels."""

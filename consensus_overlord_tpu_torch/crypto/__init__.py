"""BLS12-381 providers: the host oracle and the CUDA-batched provider."""

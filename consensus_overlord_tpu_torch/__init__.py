"""consensus_overlord_tpu_torch — the PyTorch/CUDA port of
consensus_overlord_tpu for an NVIDIA H100.

It imports torch, numpy and the standard library, never jax and nothing
of the JAX package: the JAX-free pieces it needs (SM3, the BLS12-381
oracle, hash-to-curve, the native pairing loader) are its own copies.
Every Pallas kernel on its path is a hand-written CUDA kernel under
csrc/, built with nvcc into _build/ at first use (ops/kernels.py).
Entry points run on the card (device="cuda") unless the caller asks for
the CPU, where each kernel's plain PyTorch version runs instead.
"""

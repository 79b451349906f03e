"""consensus_overlord_tpu_torch — the PyTorch/CUDA port of
consensus_overlord_tpu for an NVIDIA H100.

It imports torch, numpy and the standard library, never jax and nothing
of the JAX package: the JAX-free pieces it needs (SM3, the BLS12-381
oracle, hash-to-curve, the native pairing loader, the device circuit
breaker, the device profiler and round ids of obs/) are its own copies.
Every Pallas kernel on its path is a hand-written CUDA kernel under
csrc/, built with nvcc at first use (ops/kernels.py) into this host's
namespace of the build cache, _build/host-<fingerprint>/
(compile_cache.py; CONSENSUS_TORCH_BUILD_ROOT moves the root).
Entry points run on the card (device="cuda") unless the caller asks for
the CPU, where each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"

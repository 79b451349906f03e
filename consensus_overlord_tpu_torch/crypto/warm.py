"""Device-path prewarming for the port's entry points (sim/run.py
--prewarm).

The port's own copy of consensus_overlord_tpu/crypto/warm.py, driving
CudaBlsCrypto (``warm_bls``) and the one-path providers of Ed25519,
secp256k1 and SM2 (``warm_simple``).  On the card the first touch of a path costs what no
measured height should carry: the nvcc build of the kernel libraries
(once per checkout, kernels.load_all), the pairing programs' recording
and upload (once per process, ops/kernels.py _program), and the CUDA
context and caching allocator's first blocks at each pad rung.  Warming
runs one batch through every device path at every rung a fleet can hit
before the fleet starts.  The JAX package retries each step, for its
remote compiles; here the build happens in the provider's constructor,
so a step runs once and any exception, a device fault included, reaches
the caller.
"""

from __future__ import annotations

from typing import List, Sequence


def rungs_for(max_batch: int) -> List[int]:
    """Every pad-ladder rung a fleet coalescing batches up to
    `max_batch` lanes can hit (CONSENSUS_PAD_MIN collapses the low
    rungs — _pad_to applies it, so duplicates are filtered here)."""
    from .cuda_provider import _pad_to
    top = _pad_to(max_batch)
    seen: List[int] = []
    for n in (8, 32, 128, 512, 1024, 2048, 8192):
        r = _pad_to(min(n, max_batch))
        if r not in seen:
            seen.append(r)
        if r >= top:
            break
    return seen


def warm_bls(provider, rungs: Sequence[int],
             group_sizes: Sequence[int] | None = None) -> None:
    """Load/compile every BLS device kernel path a fleet uses at each
    rung: pubkey validation, single- and k-hash fused verify, signature
    aggregation, QC aggregate-verify.  group_sizes defaults to 1 + the
    provider's full multi-hash ladder (derived, so a ladder change
    can't silently leave a rung unwarmed and push its first-touch
    compile into live consensus rounds)."""
    from ..core.sm3 import sm3_hash
    from . import bls12381 as oracle
    from .cuda_provider import _GROUP_SIZES

    if group_sizes is None:
        group_sizes = (1,) + tuple(_GROUP_SIZES)

    top = max(rungs)
    hs = [sm3_hash(b"warm-%d" % g) for g in range(max(group_sizes))]
    sks = list(range(88000, 88000 + top))
    pks = [oracle.sk_to_pk(sk) for sk in sks]
    provider.update_pubkeys(pks)
    for n in rungs:
        for k in group_sizes:
            lane_h = [hs[i % k] for i in range(n)]
            sigs = [oracle.sign(sk, lane_h[i])
                    for i, sk in enumerate(sks[:n])]
            if not all(provider.verify_batch(sigs, lane_h, pks[:n])):
                raise RuntimeError(f"warm rung {n} {k}-hash: a valid "
                                   "vote did not verify")
        sigs = [oracle.sign(sk, hs[0]) for sk in sks[:n]]
        agg = provider.aggregate_signatures(sigs, pks[:n])
        if not provider.verify_aggregated_signature(agg, hs[0], pks[:n]):
            raise RuntimeError(f"warm rung {n}: a valid QC did not verify")


def warm_simple(provider, rungs: Sequence[int]) -> None:
    """Run the one batched-verify path of the one-path providers
    (Ed25519CudaCrypto, Secp256k1Crypto, Sm2Crypto) once at each rung."""
    h = provider.hash(b"warm")
    sig = provider.sign(h)
    for n in rungs:
        if not all(provider.verify_batch([sig] * n, [h] * n,
                                         [provider.pub_key] * n)):
            raise RuntimeError(f"warm rung {n}: a valid vote did not "
                               "verify")

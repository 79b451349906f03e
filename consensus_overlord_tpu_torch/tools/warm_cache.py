"""Warm the port's device paths for the pad-ladder rungs a deployment will
hit, so cold-start consensus rounds do not stall on first touches: the
twin of scripts/warm_cache.py, with its arguments.

It builds every kernel library (ops/kernels.py build_all) in this host's
namespace of the build cache (compile_cache.build_dir()) and prints the
build's hits and misses (0 misses once the libraries are built there),
then warms, per rung R, CudaBlsCrypto's device paths through
crypto/warm.py warm_bls: pubkey validation, the single-hash and k-hash
verify rounds, signature aggregation and the QC verify.  One line per
rung with its seconds.  Runs on the card only; exits 2 when none is
visible.

Usage: python -m consensus_overlord_tpu_torch.tools.warm_cache [rung ...]
           (default: 32 128 512)
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rungs = [int(a) for a in argv] or [32, 128, 512]
    import torch

    if not torch.cuda.is_available():
        print("warm_cache: no CUDA card is visible "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from .. import compile_cache
    from ..crypto.cuda_provider import CudaBlsCrypto
    from ..crypto.warm import warm_bls
    from ..ops import kernels

    build_s = kernels.build_all()
    stats = compile_cache.stats()
    print(f"build: {stats['hits']} hits, {stats['misses']} misses in "
          f"{compile_cache.build_dir()} ({build_s:.1f}s)", flush=True)
    provider = CudaBlsCrypto(0xFACE, device_threshold=1)
    for rung in rungs:
        t0 = time.time()
        warm_bls(provider, [rung])
        print(f"rung {rung}: warmed in {time.time() - t0:.1f}s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

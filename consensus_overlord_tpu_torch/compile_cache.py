"""Hit and miss counts of the kernel build cache.

The port's counterpart of consensus_overlord_tpu/compile_cache.py: where
the JAX package counts the persistent XLA cache's hits and misses, the
port counts lookups of its nvcc build cache (ops/kernels.py
`_start_build`: a library already built under its source hash is a hit,
one that must be compiled a miss).  The counts are process-wide; the
`compile_cache_*` gauges of obs/metrics.py and the telemetry samples
read them.  Scoping the cache directory per host is not done yet.
"""

from __future__ import annotations

import threading

_STATS = {"hits": 0, "misses": 0}
_lock = threading.Lock()


def record(hit: bool) -> None:
    """Count one build-cache lookup."""
    with _lock:
        _STATS["hits" if hit else "misses"] += 1


def stats() -> dict:
    """Snapshot of the build-cache hit/miss counts (process-wide)."""
    with _lock:
        return dict(_STATS)

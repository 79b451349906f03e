"""Carry state from the JAX package into the port.

The JAX BLS provider keeps its validated pubkey cache as numpy limb rows
(`TpuBlsCrypto._pk_px/_pk_py/_pk_pz`, each (rows, 2, 39) int32, and
`_pk_index`: voter bytes → row or −1).  The port's cache has the same
limb layout, so the rows carry over bit for bit; only the oracle affine
points of the exact per-lane fallback are recomputed on the host.  The
JAX ECDSA providers (secp256k1, SM2) keep affine key rows
(`_pk_x/_pk_y`, each (rows, 26) int32) and the same kind of index; the
port's providers keep the same three, so those carry over as they are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .crypto import bls12381 as oracle
from .crypto.cuda_provider import PubkeyCache
from .crypto.ecdsa_cuda import EcdsaPubkeyCache
from .ops.bls12381_groups import FQ
from .ops.field import SECP256K1_FQ


def _fq2_of(limbs: np.ndarray):
    """(2, n) loose limbs → the Fq2 value as an oracle int pair."""
    c0, c1 = (sum(int(d) << (FQ.b * i) for i, d in enumerate(row)) % FQ.p
              for row in np.asarray(limbs, np.int64))
    return (c0, c1)


def pubkey_cache_from_jax(px, py, pz, index: Dict[bytes, int]) -> PubkeyCache:
    """A port PubkeyCache from a JAX provider's numpy pubkey cache; load
    it with CudaBlsCrypto.load_pubkey_cache."""
    cache = PubkeyCache()
    cache.px = np.array(px, dtype=np.int32, copy=True)
    cache.py = np.array(py, dtype=np.int32, copy=True)
    cache.pz = np.array(pz, dtype=np.int32, copy=True)
    if not (cache.px.shape == cache.py.shape == cache.pz.shape
            and cache.px.shape[1:] == (2, FQ.n)):
        raise ValueError("pubkey rows must share one (rows, 2, n) shape")
    rows = cache.px.shape[0]
    cache.index = {bytes(k): int(v) for k, v in index.items()}
    if any(v >= rows for v in cache.index.values()):
        raise ValueError("pubkey index points past the cached rows")
    live = {v for v in cache.index.values() if v >= 0}
    cache.aff = [None] * rows
    for r in live:
        z = _fq2_of(cache.pz[r])
        zinv = oracle.fq2_inv(z)
        cache.aff[r] = (oracle.fq2_mul(_fq2_of(cache.px[r]), zinv),
                        oracle.fq2_mul(_fq2_of(cache.py[r]), zinv))
    return cache


def ecdsa_pubkeys_from_jax(pk_x, pk_y,
                           index: Dict[bytes, int]) -> EcdsaPubkeyCache:
    """A port ECDSA pubkey cache from a JAX Secp256k1Crypto or Sm2Crypto's
    (`_pk_x`, `_pk_y`, `_pk_index`); load it with the port provider's
    load_pubkey_cache (same curve)."""
    x = np.array(pk_x, dtype=np.int32, copy=True)
    y = np.array(pk_y, dtype=np.int32, copy=True)
    if x.shape != y.shape or x.ndim != 2 or x.shape[1] != SECP256K1_FQ.n:
        raise ValueError("pubkey rows must share one (rows, "
                         f"{SECP256K1_FQ.n}) shape")
    idx = {bytes(k): int(v) for k, v in index.items()}
    if any(v >= x.shape[0] for v in idx.values()):
        raise ValueError("pubkey index points past the cached rows")
    return EcdsaPubkeyCache(x, y, idx)

"""Signed-vote fixtures of the operator tools and chip_smoke.py.

Each fixture is a run of validator keys sk_i = sk_0 + step·i and their
signatures, built with the port's oracle one key from the one before
(pk_i = pk_{i-1} + step·G2, sig_i = sig_{i-1} + step·H, affine adds)
rather than by a scalar multiplication a key, and cached as an .npz
under the checkout's git-ignored .smoke_fixtures/.

  bench_fixture(n)        bench.py's fixture: sk_i = 0xBEEF + 97·i, one
                          vote hash sm3("bench-block-hash"), so a record
                          of the port and one of the JAX package cover
                          the same keys and votes;
  make_fixtures(seed, v)  chip_smoke.py's: sk_i = s0 + i with s0 drawn
                          from the seed, signatures on `nhash` hashes.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..core.sm3 import sm3_hash
from ..crypto import bls12381 as oracle

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".smoke_fixtures")

#: bench.py's key schedule and vote hash.
BENCH_SK0 = 0xBEEF
BENCH_STEP = 97
BENCH_MESSAGE = b"bench-block-hash"


def _key_run(sk0: int, step: int, count: int, h_pts) -> dict:
    """pks (count, 96) and sigs (len(h_pts), count, 48) compressed, of
    the keys sk0 + step·i signing each hash point."""
    pk = oracle.g2_mul(oracle.G2_GEN, sk0)
    dpk = oracle.g2_mul(oracle.G2_GEN, step)
    sig = [oracle.g1_mul(hp, sk0) for hp in h_pts]
    dsig = [oracle.g1_mul(hp, step) for hp in h_pts]
    pks, sigs = [], [[] for _ in h_pts]
    for _ in range(count):
        pks.append(oracle.g2_compress(pk))
        for g, s in enumerate(sig):
            sigs[g].append(oracle.g1_compress(s))
        pk = oracle.g2_add(pk, dpk)
        sig = [oracle.g1_add(s, d) for s, d in zip(sig, dsig)]
    return {"pks": np.frombuffer(b"".join(pks), np.uint8).reshape(count, 96),
            "sigs": np.frombuffer(b"".join(b"".join(s) for s in sigs),
                                  np.uint8).reshape(len(h_pts), count, 48)}


def _cached(name: str, build) -> dict:
    """The arrays of FIXTURE_DIR/name, built and written (atomically)
    when the file is not there."""
    path = os.path.join(FIXTURE_DIR, name)
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    arrays = build()
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays


def bench_fixture(n: int):
    """bench.py's fixture at N lanes: (sigs, hash, pks), lane i signed by
    sk_i = 0xBEEF + 97·i on the one hash sm3("bench-block-hash")."""
    h = sm3_hash(BENCH_MESSAGE)
    z = _cached(f"bench_{n}.npz", lambda: _key_run(
        BENCH_SK0, BENCH_STEP, n, [oracle.hash_to_g1(h)]))
    return [bytes(r) for r in z["sigs"][0]], h, [bytes(r) for r in z["pks"]]


def make_fixtures(seed: int, validators: int, nhash: int = 3):
    """chip_smoke.py's fixture: (s0, hashes, pks, sigs) with validator
    keys sk_i = s0 + i and their signatures on `nhash` vote hashes
    (sigs[g][i] is validator i's on hashes[g]); cached by (seed,
    validators)."""
    s0 = int.from_bytes(hashlib.sha256(
        f"chip_smoke:{seed}".encode()).digest(), "big") % oracle.R
    hashes = [sm3_hash(f"chip_smoke:{seed}:block:{g}".encode())
              for g in range(nhash)]
    z = _cached(f"fixtures_{seed}_{validators}.npz", lambda: _key_run(
        s0, 1, validators, [oracle.hash_to_g1(h) for h in hashes]))
    pks = [bytes(r) for r in z["pks"]]
    sigs = [[bytes(r) for r in z["sigs"][g]] for g in range(nhash)]
    return s0, hashes, pks, sigs

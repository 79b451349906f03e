"""The plain PyTorch versions of the port's CUDA kernels against the TPU
kernels they replace, run in Pallas interpret mode on the CPU: the
field multiply (ops/pallas_field.py, mirrored by csrc/fq_mul.cu) and the
fused G1 add/double (ops/pallas_point.py, mirrored by csrc/g1_point.cu).
Integer arithmetic: bit-identical, tolerance 0."""

import random

import jax.numpy as jnp
import numpy as np
import torch

from consensus_overlord_tpu.ops.field import BLS12_381_FQ as JFQ
from consensus_overlord_tpu.ops.pallas_field import PallasField
from consensus_overlord_tpu.ops.pallas_point import (
    g1_add_transposed, g1_dbl_transposed)
from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
from consensus_overlord_tpu_torch.ops import bls12381_groups as tdev

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)

B = 8  # one Pallas block


def test_mul_plain_matches_pallas_field():
    rng = np.random.default_rng(41)
    x = rng.integers(0, JFQ.loose_max + 1, size=(B, JFQ.n), dtype=np.int32)
    y = rng.integers(0, JFQ.loose_max + 1, size=(B, JFQ.n), dtype=np.int32)
    x[0] = y[0] = JFQ.loose_max
    want = PallasField(JFQ, block_b=B).mul(jnp.asarray(x), jnp.asarray(y))
    got = tdev.FQ.mul_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert np.array_equal(np.asarray(want), got.numpy())


def _points():
    rng = random.Random(43)
    pts = [oracle.g1_mul(oracle.G1_GEN, rng.randrange(1, oracle.R))
           for _ in range(6)]
    # Lanes: generic sums, P + P, P + O, O + P and P + (−P).
    p = pts[:5] + [None, pts[0], pts[1]]
    q = [pts[5], pts[1], pts[3], None, pts[0], pts[2], pts[0],
         oracle.g1_neg(pts[1])]
    return tdev.g1_from_oracle(p), tdev.g1_from_oracle(q)


def _t(c):
    return jnp.asarray(c.numpy().T)


def test_g1_add_plain_matches_pallas_point():
    p, q = _points()
    want = g1_add_transposed(JFQ, block_b=B)(*(_t(c) for c in p + q))
    got = tdev.G1.add_plain(p, q)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).T, g.numpy())


def test_g1_dbl_plain_matches_pallas_point():
    p, _ = _points()
    want = g1_dbl_transposed(JFQ, block_b=B)(*(_t(c) for c in p))
    got = tdev.G1.dbl_plain(p)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w).T, g.numpy())

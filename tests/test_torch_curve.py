"""The port's curve layer (consensus_overlord_tpu_torch/ops/curve.py over
G1 and G2) against the JAX package's jitted CurveOps (bit-identical
projective outputs) and against the host oracle for the deep functions
(scalar multiplication, MSM, tree sum)."""

import random

import jax
import numpy as np
import pytest
import torch

from consensus_overlord_tpu.ops import bls12381_groups as jdev
from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
from consensus_overlord_tpu_torch.ops import bls12381_groups as tdev
from consensus_overlord_tpu_torch.ops.curve import Point

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)

RNG = random.Random(0xC0FFEE)


def g1_points(k):
    return [oracle.g1_mul(oracle.G1_GEN, RNG.randrange(1, oracle.R))
            for _ in range(k)]


def g2_points(k):
    return [oracle.g2_mul(oracle.G2_GEN, RNG.randrange(1, oracle.R))
            for _ in range(k)]


def lanes(pts):
    """8 lanes exercising the complete formulas: generic pairs, the
    identity on either side, P + P and P + (−P)."""
    a, b = pts[:5], pts[5:10]
    neg = oracle.g1_neg if isinstance(a[0][0], int) else (
        lambda p: (p[0], oracle.fq2_neg(p[1])))
    return (a[:4] + [None, a[4], a[0], a[1]],
            b[:4] + [b[4], None, a[0], neg(a[1])])


def same_point(jp, tp):
    return all(np.array_equal(np.asarray(j), t.numpy())
               for j, t in zip(jp, tp))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_dbl_bit_equal_to_jax(group):
    pts = g1_points(10) if group == "g1" else g2_points(10)
    p_aff, q_aff = lanes(pts)
    jfrom = jdev.g1_from_oracle if group == "g1" else jdev.g2_from_oracle
    tfrom = tdev.g1_from_oracle if group == "g1" else tdev.g2_from_oracle
    jops = jdev.G1 if group == "g1" else jdev.G2
    tops = tdev.G1 if group == "g1" else tdev.G2
    jp, jq = jfrom(p_aff), jfrom(q_aff)
    tp, tq = tfrom(p_aff), tfrom(q_aff)
    want_add = jax.jit(jops.add)(jp, jq)
    want_dbl = jax.jit(jops.dbl)(want_add)
    got_add = tops.add(tp, tq)
    assert same_point(want_add, got_add)
    assert same_point(want_dbl, tops.dbl(got_add))
    to_oracle = tdev.g1_to_oracle if group == "g1" else tdev.g2_to_oracle
    add = oracle.g1_add if group == "g1" else oracle.g2_add
    assert to_oracle(got_add) == [add(a, b) for a, b in zip(p_aff, q_aff)]


def test_g1_plain_versions_are_the_generic_formulas():
    """On CPU tensors G1.add/dbl ARE the plain versions — the generic
    CurveOps formulas over the plain field."""
    p = tdev.g1_from_oracle(g1_points(4))
    q = tdev.g1_from_oracle(g1_points(4))
    assert all(torch.equal(a, b) for a, b in
               zip(tdev.G1.add(p, q), tdev.G1.add_plain(p, q)))
    assert all(torch.equal(a, b) for a, b in
               zip(tdev.G1.dbl(p), tdev.G1.dbl_plain(p)))


@pytest.mark.parametrize("k", [0, 1, 7, -9, 0xD201000000010000])
def test_scalar_mul_static_g1(k):
    pts = g1_points(3) + [None]
    got = tdev.g1_to_oracle(tdev.G1.scalar_mul_static(
        tdev.g1_from_oracle(pts), k))
    assert got == [oracle.g1_mul(p, k) if p is not None else None
                   for p in pts]


def _bits(scalars, nbits=64):
    b = np.array([[(s >> (nbits - 1 - i)) & 1 for i in range(nbits)]
                  for s in scalars], np.int32)
    return torch.from_numpy(b)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_bits_matches_oracle(group):
    rng = np.random.default_rng(21)
    k = 4
    pts = g1_points(k) if group == "g1" else g2_points(k)
    pts[2] = None  # an identity lane
    scalars = [int(v) for v in rng.integers(0, 2**63, size=k)]
    scalars[3] = 0  # a masked lane
    ops = tdev.G1 if group == "g1" else tdev.G2
    frm = tdev.g1_from_oracle if group == "g1" else tdev.g2_from_oracle
    to = tdev.g1_to_oracle if group == "g1" else tdev.g2_to_oracle
    add = oracle.g1_add if group == "g1" else oracle.g2_add
    mul = oracle.g1_mul if group == "g1" else oracle.g2_mul
    want = None
    for p, s in zip(pts, scalars):
        if p is not None:
            want = add(want, mul(p, s))
    assert to(ops.msm_bits(frm(pts), _bits(scalars))) == [want]


def test_scalar_mul_bits_bit_serial_form():
    """Bit counts that the window does not divide take the bit-serial
    ladder."""
    pts = g1_points(2)
    got = tdev.g1_to_oracle(tdev.G1.scalar_mul_bits(
        tdev.g1_from_oracle(pts), _bits([5, 6], nbits=3)))
    assert got == [oracle.g1_mul(pts[0], 5), oracle.g1_mul(pts[1], 6)]


def test_tree_sum_odd_batch_and_predicates():
    pts = g1_points(5)
    got = tdev.G1.tree_sum(tdev.g1_from_oracle(pts))
    want = None
    for p in pts:
        want = oracle.g1_add(want, p)
    assert tdev.g1_to_oracle(got) == [want]
    p = tdev.g1_from_oracle(pts[:2] + [None])
    assert tdev.G1.on_curve(p).tolist() == [True, True, True]
    assert tdev.G1.is_infinity(p).tolist() == [False, False, True]
    scaled = Point(tdev.FQ.mul_small(p.x, 5), tdev.FQ.mul_small(p.y, 5),
                   tdev.FQ.mul_small(p.z, 5))  # same points, Z = 5
    assert tdev.G1.eq(p, scaled).tolist() == [True, True, True]
    assert tdev.G1.eq(p, tdev.G1.neg(p)).tolist() == [False, False, True]

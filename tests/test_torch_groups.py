"""The port's BLS12-381 group layer (consensus_overlord_tpu_torch/ops/
bls12381_groups.py): wire parsers byte-equal to the JAX package's,
decompression and the per-lane subgroup checks against the host oracle
(including the TestSubgroupAttack inputs of tests/test_tpu_provider.py),
and the verify round's small device steps against JAX."""

import jax.numpy as jnp
import numpy as np
import torch

from consensus_overlord_tpu.ops import bls12381_groups as jdev
from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
from consensus_overlord_tpu_torch.ops import bls12381_groups as tdev

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)


def non_subgroup_g1_point():
    """An on-curve G1 point outside the r-torsion subgroup."""
    x = 7
    while True:
        rhs = (pow(x, 3, oracle.P) + 4) % oracle.P
        y = pow(rhs, (oracle.P + 1) // 4, oracle.P)
        if y * y % oracle.P == rhs and not oracle.g1_in_subgroup((x, y)):
            return (x, y)
        x += 1


def g1_blobs():
    sig = oracle.g1_mul(oracle.G1_GEN, 0xABCDEF)
    torsion = oracle.g1_add(sig, (0, 2))  # order-3 component
    return [
        oracle.g1_compress(sig),
        oracle.g1_compress(oracle.g1_neg(sig)),
        oracle.g1_compress(None),                 # infinity
        oracle.g1_compress(torsion),
        oracle.g1_compress(non_subgroup_g1_point()),
        b"\x00" * 48,                             # no compressed flag
        bytes([0x9F]) + b"\xff" * 47,             # x >= p
        b"short",
    ]


def g2_blobs():
    pk = oracle.g2_mul(oracle.G2_GEN, 0x1234567)
    return [
        oracle.g2_compress(pk),
        oracle.g2_compress((pk[0], oracle.fq2_neg(pk[1]))),
        oracle.g2_compress(None),
        b"\x01" * 96,
        bytes([0xE0]) + b"\x00" * 95,             # infinity with sign bit
        b"\x80" + b"\x00" * 95,                   # x = 0: not on the curve
    ]


def test_wire_parsers_byte_equal_to_jax():
    for tp, jp in ((tdev.parse_g1_compressed(g1_blobs()),
                    jdev.parse_g1_compressed(g1_blobs())),
                   (tdev.parse_g2_compressed(g2_blobs()),
                    jdev.parse_g2_compressed(g2_blobs()))):
        for t, j in zip(tp, jp):
            assert t.dtype == j.dtype and t.tobytes() == j.tobytes()


def _g1_validate(blobs):
    parsed = tdev.parse_g1_compressed(blobs)
    return tdev.g1_validate_batch(*(torch.from_numpy(a) for a in parsed))


def test_g1_validate_batch_against_oracle():
    """Decompress + per-lane subgroup check: honest lanes decode to the
    oracle's points; infinity, torsion, non-subgroup and malformed lanes
    are invalid and become the identity."""
    blobs = g1_blobs()
    pt, valid = _g1_validate(blobs)
    want = []
    for b in blobs:
        try:
            p = oracle.g1_decompress(b)
        except ValueError:
            p = None
        want.append(p is not None and oracle.g1_in_subgroup(p))
    assert valid.tolist() == want == [True, True] + [False] * 6
    got = tdev.g1_to_oracle(pt)
    assert got[:2] == [oracle.g1_decompress(b) for b in blobs[:2]]
    assert got[2:] == [None] * 6


def test_g1_decompress_matches_jax():
    parsed = tdev.parse_g1_compressed(g1_blobs())
    jpt, jvalid = jdev.g1_decompress_device(*(jnp.asarray(a) for a in parsed))
    tpt, tvalid = tdev.g1_decompress_device(
        *(torch.from_numpy(a) for a in parsed))
    assert np.array_equal(np.asarray(jvalid), tvalid.numpy())
    for j, t in zip(jpt, tpt):
        assert np.array_equal(np.asarray(j), t.numpy())


def test_g2_decompress_and_subgroup_against_oracle():
    blobs = g2_blobs()
    parsed = tdev.parse_g2_compressed(blobs)
    pt, valid = tdev.g2_decompress_device(
        *(torch.from_numpy(a) for a in parsed))
    in_sub = tdev.g2_in_subgroup(pt)
    want = []
    for b in blobs:
        try:
            want.append(oracle.g2_decompress(b))
        except ValueError:
            want.append(False)
    assert valid.tolist() == [w is not False for w in want]
    got = tdev.g2_to_oracle(pt)
    assert got[:3] == want[:3]
    assert in_sub[:3].tolist() == [True, True, True]


def test_g2_subgroup_rejects_twist_points_off_the_subgroup():
    """A point on the twist but outside G2 (found by x-increment, no
    cofactor clearing) fails the ψ criterion, as the oracle says."""
    x0, pts = 1, []
    while len(pts) < 2:
        x = (x0, 1)
        rhs = oracle.fq2_add(oracle.fq2_mul(oracle.fq2_sq(x), x), (4, 4))
        y = oracle.fq2_sqrt(rhs)
        if y is not None:
            pts.append((x, y))
        x0 += 1
    pts.append(oracle.g2_mul(oracle.G2_GEN, 99))
    got = tdev.g2_in_subgroup(tdev.g2_from_oracle(pts)).tolist()
    assert got == [oracle.g2_in_subgroup(p) for p in pts]
    assert got[-1] and not all(got)


def test_unpack_weight_bits_and_gather_rows_match_jax():
    rng = np.random.default_rng(31)
    w = rng.integers(0, 256, size=(8, 8), dtype=np.uint8)
    assert np.array_equal(np.asarray(jdev.unpack_weight_bits(jnp.asarray(w))),
                          tdev.unpack_weight_bits(torch.from_numpy(w)).numpy())
    rows = np.array([3, 0, 0, 2], np.int64)
    cache = [rng.integers(0, 4096, size=(4, 2, 39), dtype=np.int32)
             for _ in range(3)]
    jp = jdev.gather_rows(jnp.asarray(rows), *(jnp.asarray(c) for c in cache))
    tp = tdev.gather_rows(torch.from_numpy(rows),
                          *(torch.from_numpy(c) for c in cache))
    for j, t in zip(jp, tp):
        assert np.array_equal(np.asarray(j), t.numpy())


def test_plain_field_routes_agree_with_each_other_and_jax():
    """The plain field arithmetic has two routes over one code path: numpy
    views for CPU tensors (what every CPU test runs) and torch ops (what
    CUDA tensors run, here on CPU tensors).  For each field, on seeded
    loose limbs, both give JAX's FieldSpec.mul limb for limb, and the
    same reduction of an add and of a sub."""
    from consensus_overlord_tpu.ops import edwards as jed
    from consensus_overlord_tpu.ops import field as jfield
    from consensus_overlord_tpu.ops import weierstrass as jw
    from consensus_overlord_tpu_torch.ops import field as tfield

    rng = np.random.default_rng(41)
    for jspec, spec in zip(
            (jfield.BLS12_381_FQ, jed.FE, jw.FQ_SECP, jw.FQ_SM2),
            (tfield.BLS12_381_FQ, tfield.ED25519_FQ, tfield.SECP256K1_FQ,
             tfield.SM2_FQ)):
        x, y = (rng.integers(0, spec.loose_max + 1, size=(5, spec.n),
                             dtype=np.int32) for _ in range(2))
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        fold = spec.const("fold", "cpu")

        def torch_route(acc, bounds):
            plan = spec._plan(list(bounds))
            return spec._run_plan(acc, plan, fold, tfield._TORCH_OPS)

        want = np.asarray(jspec.mul(jnp.asarray(x), jnp.asarray(y)))
        conv = spec._conv(tx, ty, tfield._TORCH_OPS)
        assert np.array_equal(torch_route(conv, spec._mul_bounds).numpy(),
                              want)
        assert np.array_equal(spec.mul_plain(tx, ty).numpy(), want)
        for acc, bounds in ((tx + ty, spec._small_bounds(2)),
                            (tx + (spec.const("pad", "cpu") - ty),
                             spec._sub_bounds)):
            assert torch.equal(torch_route(acc.clone(), bounds),
                               spec._reduce(acc.clone(), bounds))

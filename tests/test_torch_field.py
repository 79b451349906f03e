"""The port's field layer (consensus_overlord_tpu_torch/ops/field.py,
ops/fq2.py) against the JAX package's: same inputs from a numpy seed,
bit-identical loose outputs (integer arithmetic, tolerance 0), and the
fq_mul kernel wrapper's guards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_overlord_tpu.ops.field import BLS12_381_FQ as JFQ
from consensus_overlord_tpu.ops.fq2 import Fq2Ops as JFq2Ops
from consensus_overlord_tpu_torch.ops import kernels
from consensus_overlord_tpu_torch.ops.field import BLS12_381_FQ as TFQ
from consensus_overlord_tpu_torch.ops.field import FieldSpec, _digits
from consensus_overlord_tpu_torch.ops.fq2 import Fq2Ops

# One intra-op thread: the suite runs several worker processes, and
# torch's thread pool across them oversubscribes the cores (a 24-lane
# exponentiation measured 100x slower that way).
torch.set_num_threads(1)

B = 8
JFQ2 = JFq2Ops(JFQ)
TFQ2 = Fq2Ops(TFQ)


def loose(rng, shape):
    """Random loose limbs, the first row of the batch at the bound."""
    x = rng.integers(0, TFQ.loose_max + 1, size=shape + (TFQ.n,),
                     dtype=np.int32)
    x.reshape(-1, TFQ.n)[0] = TFQ.loose_max
    return x


def same(jax_out, torch_out):
    return np.array_equal(np.asarray(jax_out), torch_out.numpy())


@pytest.mark.parametrize("bounds", [
    "conv", "add2", "sub", "neg", "small2", "small3", "small8", "small12"])
def test_plans_equal(bounds):
    n, L, pad = TFQ.n, TFQ.loose_max, int(TFQ._pad_np.max())
    b = {"conv": TFQ._conv_bounds(), "add2": [2 * L] * n,
         "sub": [L + pad] * n, "neg": [pad] * n, "small2": [2 * L] * n,
         "small3": [3 * L] * n, "small8": [8 * L] * n,
         "small12": [12 * L] * n}[bounds]
    assert TFQ._plan(list(b)) == JFQ._plan(list(b))
    assert np.array_equal(TFQ._fold_np, JFQ._fold_np)
    assert np.array_equal(TFQ._pad_np, JFQ._pad_np)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "mul_plain"])
def test_binary_ops_bit_equal(op):
    rng = np.random.default_rng(11)
    x, y = loose(rng, (B,)), loose(rng, (B,))
    want = getattr(JFQ, "mul" if op == "mul_plain" else op)(
        jnp.asarray(x), jnp.asarray(y))
    got = getattr(TFQ, op)(torch.from_numpy(x), torch.from_numpy(y))
    assert same(want, got)


@pytest.mark.parametrize("k", [2, 3, 8, 12])
def test_neg_and_mul_small_bit_equal(k):
    rng = np.random.default_rng(12 + k)
    x = loose(rng, (B,))
    assert same(JFQ.neg(jnp.asarray(x)), TFQ.neg(torch.from_numpy(x)))
    assert same(JFQ.mul_small(jnp.asarray(x), k),
                TFQ.mul_small(torch.from_numpy(x), k))


def test_strict_and_predicates():
    rng = np.random.default_rng(13)
    x = loose(rng, (B,))
    x[1] = 0
    x[2] = TFQ.from_int(TFQ.p - 1)
    x[3] = _digits(TFQ.p, TFQ.b, TFQ.n)  # p itself: a loose zero
    x[4] = TFQ._pad_np  # a multiple of p with every limb above the bound
    x[4] %= TFQ.loose_max + 1
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert same(JFQ.strict(jx), TFQ.strict(tx))
    assert same(JFQ.is_zero(jx), TFQ.is_zero(tx))
    y = np.roll(x, 1, axis=0)
    y[0] = x[0]
    assert same(JFQ.eq(jx, jnp.asarray(y)), TFQ.eq(tx, torch.from_numpy(y)))
    for c in (0, 1, (TFQ.p - 1) // 2 + 1, TFQ.p - 1):
        assert same(JFQ.geq_const(jx, c), TFQ.geq_const(tx, c))
    assert TFQ.to_ints(tx) == JFQ.to_ints(jx)


@pytest.mark.parametrize("e", [0, 1, 5, 0xBEEF, "inv", "sqrt"])
def test_pow_inv_sqrt_bit_equal(e):
    rng = np.random.default_rng(14)
    x = loose(rng, (B,))
    x[1] = 0
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if e == "inv":
        want, got = JFQ.inv(jx), TFQ.inv(tx)
    elif e == "sqrt":
        want, got = JFQ.sqrt_candidate(jx), TFQ.sqrt_candidate(tx)
    else:
        want, got = JFQ.pow_static(jx, e), TFQ.pow_static(tx, e)
    assert same(want, got)


def test_conversions():
    vals = [0, 1, 2**380, TFQ.p - 1, 12345678901234567890]
    assert np.array_equal(TFQ.from_ints(vals), JFQ.from_ints(vals))
    assert TFQ.ints_from_strict(TFQ.from_ints(vals)) == [v % TFQ.p
                                                          for v in vals]


def test_other_moduli_stay_generic():
    """The spec is modulus-generic on the CPU (secp256k1 here)."""
    p = 2**256 - 2**32 - 977
    f = FieldSpec(p, limb_bits=10, name="secp256k1")
    rng = np.random.default_rng(15)
    a, b = (int.from_bytes(rng.bytes(31), "big") for _ in range(2))
    x = torch.from_numpy(f.from_ints([a]))
    y = torch.from_numpy(f.from_ints([b]))
    assert f.to_ints(f.mul(x, y)) == [a * b % p]
    assert f.to_ints(f.inv(x)) == [pow(a, -1, p)]


@pytest.mark.parametrize("op", ["mul", "sq", "mul_small_xi", "conj", "inv",
                                "is_lex_largest"])
def test_fq2_bit_equal(op):
    rng = np.random.default_rng(16)
    x, y = loose(rng, (B, 2)), loose(rng, (B, 2))
    x[1, 1] = 0  # c1 == 0 lane for is_lex_largest's tie-break
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if op == "mul":
        want, got = JFQ2.mul(jx, jnp.asarray(y)), TFQ2.mul(
            tx, torch.from_numpy(y))
    elif op == "mul_small_xi":
        want, got = JFQ2.mul_small_xi(jx, 12), TFQ2.mul_small_xi(tx, 12)
    else:
        want, got = getattr(JFQ2, op)(jx), getattr(TFQ2, op)(tx)
    assert same(want, got)


def test_fq2_sqrt_checked_against_oracle():
    """The branchless square root finds a root exactly when the oracle's
    fq2_sqrt does (JAX's eager twin takes ~40 s of scan compiles on the
    CPU, so the oracle decides here; its building blocks are pinned
    bit-equal above)."""
    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    vals = [(4, 4), oracle.fq2_sq((5, 7)), oracle.fq2_sq((9, 0)),
            oracle.fq2_sq((0, 3)), (3, 0), (0, 0), (1, 1), (2, 5)]
    root, ok = TFQ2.sqrt_checked(torch.from_numpy(TFQ2.from_ints(vals)))
    for v, r, k in zip(vals, TFQ2.to_int_pairs(root), ok.tolist()):
        assert k == (oracle.fq2_sqrt(v) is not None)
        if k:
            assert oracle.fq2_sq(r) == v


def test_kernel_wrapper_refuses_cpu_tensors():
    """A wrapper launches its kernel or raises: it never runs the plain
    version for a tensor it was handed."""
    x = torch.zeros((B, TFQ.n), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fq_mul(TFQ, x, x)


def test_kernel_tables_fit_the_kernels():
    """The table is every fold row, then the pad; the kernels take any
    field of 10-bit limbs up to BLS12-381's 39, so a 26-limb field's
    table fits and a field of 11-bit limbs is refused."""
    tab = kernels.fq_tables(TFQ)
    rows = kernels.fold_rows(TFQ)
    assert tab.dtype == np.int32 and tab.size == kernels.table_ints(TFQ)
    fold = tab[:rows * TFQ.n].reshape(-1, TFQ.n)
    assert rows == 47 and np.array_equal(fold, TFQ._fold_np[:rows])
    ed = FieldSpec(2**255 - 19, limb_bits=10)
    assert kernels.fq_tables(ed).size == kernels.table_ints(ed)
    with pytest.raises(ValueError):
        kernels.fq_tables(FieldSpec(2**255 - 19, limb_bits=11))

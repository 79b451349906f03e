"""The port's pairing tower (consensus_overlord_tpu_torch/ops/fq6.py,
fq12.py, pairing.py) against the JAX package's on the CPU, and the
pairing kernels' programs (ops/tower_program.py) against the plain
tower.

* Every Fq6/Fq12 op and the Miller step's pieces: the same numpy-seeded
  loose limbs (one element of each batch at the loose bound) through the
  JAX package's jitted op and the port's, bit-identical loose limbs
  (integer arithmetic, tolerance 0).  Only small jits are compiled here:
  the reference's whole Miller loop and final exponentiation are its
  heaviest compiles and are not.
* Whole pairings (plain tower) against the host oracle: the cubed
  pairing value, bilinearity, and multi-pairing verdicts with infinity
  and masked pairs.  A full pairing costs about 2 s on one CPU thread, so
  each test batches its pairings into one call.
* The three kernels' programs, run by ``run_program`` (the kernels'
  walk of the same table: epoch by epoch, warp by warp, one field call a
  step, the warps of an epoch in any order), equal the plain versions bit
  for bit, keep the invariants the CUDA interpreter relies on, and have
  no race between warps or lane groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_overlord_tpu.ops import pairing as jpr
from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
from consensus_overlord_tpu_torch.ops import kernels
from consensus_overlord_tpu_torch.ops import pairing as tpr
from consensus_overlord_tpu_torch.ops import tower_program as tprog
from consensus_overlord_tpu_torch.ops.field import BLS12_381_FQ

# One intra-op thread: several worker processes share the cores.
torch.set_num_threads(1)

N = BLS12_381_FQ.n
L = BLS12_381_FQ.loose_max
NEG_G2 = (oracle.G2_GEN[0], oracle.fq2_neg(oracle.G2_GEN[1]))


def loose(rng, *shape):
    """Random loose limbs of shape + (n,); element 0 at the loose bound."""
    x = rng.integers(0, L + 1, size=shape + (N,), dtype=np.int32)
    x.reshape((shape[0], -1, N))[0] = L
    return x


def same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out), torch_out.numpy())


def both(fn, *arrays):
    """fn over the JAX package's tower (jitted) and the port's, on the same
    numpy inputs."""
    want = jax.jit(lambda *a: fn(jpr, *a))(*(jnp.asarray(a) for a in arrays))
    got = fn(tpr, *(torch.from_numpy(a) for a in arrays))
    return want, got


FQ6_OPS = {
    "add": lambda m, x, y, b0, b1: m.FQ6.add(x, y),
    "sub": lambda m, x, y, b0, b1: m.FQ6.sub(x, y),
    "neg": lambda m, x, y, b0, b1: m.FQ6.neg(x),
    "mul_xi": lambda m, x, y, b0, b1: m.FQ6.mul_xi(x),
    "mul": lambda m, x, y, b0, b1: m.FQ6.mul(x, y),
    "sq": lambda m, x, y, b0, b1: m.FQ6.sq(x),
    "mul_v": lambda m, x, y, b0, b1: m.FQ6.mul_v(x),
    "mul_by_01": lambda m, x, y, b0, b1: m.FQ6.mul_by_01(x, b0, b1),
    "mul_by_1": lambda m, x, y, b0, b1: m.FQ6.mul_by_1(x, b1),
    "inv": lambda m, x, y, b0, b1: m.FQ6.inv(x),
}


@pytest.mark.parametrize("op", list(FQ6_OPS))
def test_fq6_op_bit_identical(op):
    rng = np.random.default_rng(61)
    want, got = both(FQ6_OPS[op], loose(rng, 3, 3, 2), loose(rng, 3, 3, 2),
                     loose(rng, 3, 2), loose(rng, 3, 2))
    assert same(want, got)


FQ12_OPS = {
    "add": lambda m, x, y, a0, a1, a4: m.FQ12.add(x, y),
    "mul": lambda m, x, y, a0, a1, a4: m.FQ12.mul(x, y),
    "sq": lambda m, x, y, a0, a1, a4: m.FQ12.sq(x),
    "conj": lambda m, x, y, a0, a1, a4: m.FQ12.conj(x),
    "inv": lambda m, x, y, a0, a1, a4: m.FQ12.inv(x),
    "mul_by_014": lambda m, x, y, a0, a1, a4: m.FQ12.mul_by_014(x, a0, a1,
                                                                a4),
    "cyc_sq": lambda m, x, y, a0, a1, a4: m.FQ12.cyc_sq(x),
    "cyc_pow_abs": lambda m, x, y, a0, a1, a4: m.FQ12.cyc_pow_abs(x, 0b10110),
    "frobenius": lambda m, x, y, a0, a1, a4: m.FQ12.frobenius(x),
}


@pytest.mark.parametrize("op", list(FQ12_OPS))
def test_fq12_op_bit_identical(op):
    rng = np.random.default_rng(67)
    want, got = both(FQ12_OPS[op], loose(rng, 2, 2, 3, 2),
                     loose(rng, 2, 2, 3, 2), loose(rng, 2, 2),
                     loose(rng, 2, 2), loose(rng, 2, 2))
    assert same(want, got)


MILLER_STEP = {
    "dbl_line": lambda m, x, y, z, qx, qy, f, px, py: m._dbl_line(
        m.Point(x, y, z)),
    "add_line": lambda m, x, y, z, qx, qy, f, px, py: m._add_line(
        m.Point(x, y, z), qx, qy),
    "sparse_line": lambda m, x, y, z, qx, qy, f, px, py: m._sparse_line(
        f, x, y, z, px, py),
    "g2_dbl": lambda m, x, y, z, qx, qy, f, px, py: tuple(m.G2.dbl(
        m.Point(x, y, z))),
    "g2_add": lambda m, x, y, z, qx, qy, f, px, py: tuple(m.G2.add(
        m.Point(x, y, z), m.G2.from_affine(qx, qy))),
}


@pytest.mark.parametrize("piece", list(MILLER_STEP))
def test_miller_step_piece_bit_identical(piece):
    """One Miller step's pieces on the step's operands: R projective, Q
    affine (Fq2), the accumulator f, P affine (Fq)."""
    rng = np.random.default_rng(71)
    args = [loose(rng, 2, 2) for _ in range(5)]
    args += [loose(rng, 2, 2, 3, 2), loose(rng, 2), loose(rng, 2)]
    want, got = both(MILLER_STEP[piece], *args)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    assert all(same(w, g) for w, g in zip(want, got))


def _pairs(g1, g2):
    px, py, pinf = tpr.g1_affine_from_oracle(g1)
    qx, qy, qinf = tpr.g2_affine_from_oracle(g2)
    return tuple(torch.from_numpy(a) for a in (px, py, pinf, qx, qy, qinf))


def test_pairing_matches_the_host_and_is_bilinear():
    """e(aP, Q) and e(P, aQ) in one batched call: the first equals the
    host oracle's pairing (the shared cube) canonically, and the two are
    equal."""
    a = 0x5EED
    p = oracle.g1_mul(oracle.G1_GEN, 0x1234567)
    q = oracle.g2_mul(oracle.G2_GEN, 0x7654321)
    px, py, _, qx, qy, _ = _pairs([oracle.g1_mul(p, a), p],
                                  [q, oracle.g2_mul(q, a)])
    e = tpr.FQ12.to_int_pairs(tpr.pairing(px, py, qx, qy))
    assert e[0] == oracle.pairing(q, oracle.g1_mul(p, a))
    assert e[0] == e[1]


def test_multi_pairing_verdicts_match_the_host():
    """Three flushes padded to the 5-pair rung, as one batched staged call
    (pairs on the leading axis, flushes on the next): a true relation, a
    forged one (a valid point that is not the signature) and a true one
    with an infinity pair and masked padding — the verdicts of the host
    oracle, which skips None pairs."""
    sk, h = 0xBEEF, oracle.hash_to_g1(b"\x07" * 32)
    pk = oracle.g2_mul(oracle.G2_GEN, sk)
    sig = oracle.g1_mul(h, sk)
    flushes = [[(sig, NEG_G2), (h, pk)],
               [(oracle.g1_mul(sig, 5), NEG_G2), (h, pk)],
               [(sig, NEG_G2), (h, pk), (None, pk)]]
    cols = []
    for pairs in flushes:
        pad = [(h, pk)] * (5 - len(pairs))
        cols.append(_pairs([p for p, _ in pairs + pad],
                           [q for _, q in pairs + pad]))
    px, py, pinf, qx, qy, qinf = (torch.stack(t, 1) for t in zip(*cols))
    mask = torch.tensor([[i < len(f) for f in flushes] for i in range(5)])
    got = tpr.multi_pairing_is_one_staged(px, py, pinf, qx, qy, qinf, mask)
    want = [oracle.multi_pairing_is_one(f) for f in flushes]
    assert got.tolist() == want == [True, False, True]


# -- the kernels' programs --------------------------------------------------------

PROGRAMS = ["fq12_mul", "miller_product", "final_exp", "fq_inv", "fq_inv12"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_invariants(name):
    """What csrc/pairing.cu relies on (program format 2): both lane groups
    of a warp run one kind at every step and share its barrier flag; each
    warp's stream ends every epoch with one barrier step; registers,
    operands and kinds fit their fields; padding ops write the trash
    register, which nothing else writes or reads; the steps are 16-byte
    aligned in the table."""
    prog = tprog.program(name, BLS12_381_FQ)
    assert int(prog.words[0]) == tprog.VERSION
    assert prog.warps == tprog.WARPS == kernels.TOWER_THREADS // 32
    starts = prog.warp_start
    assert starts[0] == 0 and starts[-1] == prog.nsteps
    assert np.all(np.diff(starts) >= prog.nepochs)
    header = tprog.HEADER + len(prog.const_regs) + len(prog.in_regs) + \
        len(prog.out_regs) + prog.warps + 1
    assert (len(prog.words) - 4 * prog.nsteps) % 4 == 0
    assert 0 <= len(prog.words) - 4 * prog.nsteps - header < 4
    words = prog.words[-4 * prog.nsteps:].reshape(-1, 2, 2)
    assert np.all(words[:, 0, 0] & tprog.BARRIER ==
                  words[:, 1, 0] & tprog.BARRIER)
    assert np.all(prog.kind[:, 0] == prog.kind[:, 1])
    nop = prog.kind[:, 0] == tprog.NOP
    assert prog.kind[~nop].max() < len(tprog.KINDS)
    for w in range(prog.warps):
        flags = prog.barrier[starts[w]:starts[w + 1]]
        assert flags.sum() == prog.nepochs and (flags[-1] or not len(flags))
    real = ~nop
    trash = prog.nregs - 1
    regs = [prog.dst[real], prog.a[real], prog.b[real], prog.const_regs,
            prog.in_regs, prog.out_regs]
    assert max(int(r.max()) for r in regs if r.size) < prog.nregs
    assert np.all(prog.dst[real][:, 0] != trash)
    assert not np.any(prog.a[real] == trash) and \
        not np.any(prog.b[real] == trash)
    pad = real & (prog.dst[:, 1] == trash)
    assert np.all(prog.a[pad, 1] == prog.a[pad, 0])
    assert trash not in set(prog.const_regs) | set(prog.in_regs) | \
        set(prog.out_regs)
    assert len(prog.consts) == len(prog.const_regs)


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_hazards(name):
    """No race in the schedule: a register that a warp writes in an epoch
    is read and written by no other warp in that epoch (so a value
    crosses warps only at a block barrier, and a register is reused by
    another warp only after one); the two lane groups of a step neither
    read each other's destination nor share one, so a value crosses
    lane groups only at the __syncwarp between steps."""
    prog = tprog.program(name, BLS12_381_FQ)
    real = prog.kind[:, 0] != tprog.NOP
    trash = prog.nregs - 1
    e, w = prog.epoch[real], prog.warp[real]
    key = lambda r: e[:, None] * prog.nregs + r  # noqa: E731
    written = prog.dst[real] != trash
    wkeys, wwarp = key(prog.dst[real])[written], np.broadcast_to(
        w[:, None], written.shape)[written]
    rkeys = np.concatenate([key(prog.a[real]).ravel(),
                            key(prog.b[real]).ravel()])
    rwarp = np.concatenate([np.repeat(w, 2), np.repeat(w, 2)])
    keys = np.concatenate([wkeys, rkeys])
    warps = np.concatenate([wwarp, rwarp])
    touched = np.isin(keys, wkeys)
    lo, hi = {}, {}
    for k, ww in zip(keys[touched].tolist(), warps[touched].tolist()):
        lo[k] = min(lo.get(k, ww), ww)
        hi[k] = max(hi.get(k, ww), ww)
    assert lo == hi
    d, a, b = prog.dst[real], prog.a[real], prog.b[real]
    for g in (0, 1):
        mine = d[:, g] != trash
        assert not np.any(mine & ((d[:, g] == a[:, 1 - g]) |
                                  (d[:, g] == b[:, 1 - g])))
    assert not np.any((d[:, 0] == d[:, 1]))


@pytest.mark.parametrize("order", ["reverse", 7])
@pytest.mark.parametrize("name", ["fq12_mul", "miller_product"])
def test_program_in_any_warp_order_matches_plain(name, order):
    """run_program visits the warps of each epoch in reverse and in a
    seeded shuffled order (the kernel fixes no order between warps): the
    result is the plain version's all the same."""
    rng = np.random.default_rng(97)
    prog = tprog.program(name, BLS12_381_FQ)
    if name == "fq12_mul":
        x, y = (torch.from_numpy(loose(rng, 2, 2, 3, 2)) for _ in range(2))
        ins = torch.cat([x.reshape(2, 12, N), y.reshape(2, 12, N)], 1)
        want = tpr.FQ12.mul(x, y)
    else:
        px, py = (torch.from_numpy(loose(rng, 1)) for _ in range(2))
        qx, qy = (torch.from_numpy(loose(rng, 1, 2)) for _ in range(2))
        ins = torch.cat([px[:, None], py[:, None], qx, qy], 1)
        want = tpr.miller_loop(px, py, qx, qy)
    got = tprog.run_program(prog, BLS12_381_FQ, ins, order=order)
    assert torch.equal(got.reshape(want.shape), want)


def test_fq12_mul_program_matches_plain():
    rng = np.random.default_rng(73)
    x, y = (torch.from_numpy(loose(rng, 3, 2, 3, 2)) for _ in range(2))
    prog = tprog.program("fq12_mul", BLS12_381_FQ)
    ins = torch.cat([x.reshape(3, 12, N), y.reshape(3, 12, N)], 1)
    got = tprog.run_program(prog, BLS12_381_FQ, ins).reshape(x.shape)
    assert torch.equal(got, tpr.FQ12.mul(x, y))


def test_miller_product_program_matches_plain():
    """Two pairs of loose limbs: the program's Miller loop is the plain
    miller_loop bit for bit (the kernel writes one for a skipped pair
    itself)."""
    rng = np.random.default_rng(79)
    px, py = (torch.from_numpy(loose(rng, 2)) for _ in range(2))
    qx, qy = (torch.from_numpy(loose(rng, 2, 2)) for _ in range(2))
    prog = tprog.program("miller_product", BLS12_381_FQ)
    ins = torch.cat([px[:, None], py[:, None], qx, qy], 1)
    got = tprog.run_program(prog, BLS12_381_FQ, ins)
    assert torch.equal(got.reshape(2, 2, 3, 2, N),
                       tpr.miller_loop(px, py, qx, qy))


def test_final_exp_program_matches_plain():
    rng = np.random.default_rng(83)
    f = torch.from_numpy(loose(rng, 1, 2, 3, 2))
    prog = tprog.program("final_exp", BLS12_381_FQ)
    got = tprog.run_program(prog, BLS12_381_FQ, f.reshape(1, 12, N))
    assert torch.equal(got.reshape(f.shape),
                       tpr.FQ12.final_exponentiation(f))


def test_fq_inv12_program_matches_the_inversion_chain():
    """Twelve elements a lane (kernels.fq_inv's packing), one of them 0:
    the program is FieldSpec.inv_chain bit for bit, element by element."""
    rng = np.random.default_rng(87)
    x = torch.from_numpy(loose(rng, 2, 12))
    x[1, 5] = 0
    prog = tprog.program("fq_inv12", BLS12_381_FQ)
    got = tprog.run_program(prog, BLS12_381_FQ, x)
    assert torch.equal(got, BLS12_381_FQ.inv_chain(x))
    assert not got[1, 5].any()


def test_field_inv_takes_the_chain_off_the_card():
    """FieldSpec.inv of CPU tensors is inv_chain and launches nothing;
    fq_inv serves only a field the pairing library is built for, and
    refuses CPU tensors; PlainField's inv is its own chain."""
    from consensus_overlord_tpu_torch.ops.field import (
        ED25519_FQ, SECP256K1_FQ, SM2_FQ, PlainField)
    rng = np.random.default_rng(91)
    x = torch.from_numpy(loose(rng, 3))
    before = kernels.counts()
    assert torch.equal(BLS12_381_FQ.inv(x), BLS12_381_FQ.inv_chain(x))
    assert torch.equal(PlainField(BLS12_381_FQ).inv(x),
                       BLS12_381_FQ.inv_chain(x))
    assert kernels.counts() == before
    assert BLS12_381_FQ.to_ints(BLS12_381_FQ.mul(
        BLS12_381_FQ.inv(x), x)) == [1, 1, 1]
    assert kernels.has_fq_inv(BLS12_381_FQ)
    assert not any(kernels.has_fq_inv(f)
                   for f in (ED25519_FQ, SECP256K1_FQ, SM2_FQ))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fq_inv(BLS12_381_FQ, x)


def test_pairing_wrappers_take_the_plain_path_on_the_cpu():
    """On CPU tensors the staged entry points run the plain tower and
    launch nothing; the kernels' own wrappers refuse CPU tensors."""
    rng = np.random.default_rng(89)
    x, y = (torch.from_numpy(loose(rng, 2, 2, 3, 2)) for _ in range(2))
    before = kernels.counts()
    assert torch.equal(tpr.fq12_mul(x, y), tpr.FQ12.mul(x, y))
    assert kernels.counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fq12_mul(BLS12_381_FQ, x, y)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.final_exp(BLS12_381_FQ, x)

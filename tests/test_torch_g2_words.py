"""The word design of the G2 kernels on the CPU, in Python integers: the
constants csrc/g2_point.cu is built with against their definitions from
p, and ops/g2_words.py's integer model of entry, exit, the quotient step,
REDC and the two programs, replayed on extreme and random loose inputs
with every word range checked, against the plain group law of
ops/bls12381_groups.py.  No GPU, no JAX compile."""

import re

import numpy as np
import pytest
import torch

from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
from consensus_overlord_tpu_torch.ops import g2_words as gw
from consensus_overlord_tpu_torch.ops import kernels

P = gw.P
LOOSE_TOP = sum(gw.LOOSE_MAX << (10 * i) for i in range(gw.LIMBS))


def _header_ints(text):
    """FPW_<name>_<k> word macros of the generated header → integers."""
    words = {}
    for name, k, v in re.findall(r"#define FPW_(\w+?)_(\d+) (0x[0-9a-f]+)u",
                                 text):
        words.setdefault(name, {})[int(k)] = int(v, 16)
    return {name: sum(w << (32 * k) for k, w in ws.items())
            for name, ws in words.items()}


def test_constants_equal_their_definitions():
    assert P % (1 << 32) * gw.PINV % (1 << 32) == (1 << 32) - 1
    assert gw.PTOP1 == (P >> 352) + 1
    assert gw.NEG == (0, 2 * P, 4 * P)
    assert gw.CORR == (pow(2, 4 * 384, P), 2 * pow(2, 4 * 384, P) % P)
    name, text = kernels.lib_header("g2_point")
    assert name == "g2_words.h" and text == gw.header_text()
    assert _header_ints(text) == {"P": P, "2P": 2 * P, "4P": 4 * P}
    assert f"#define FPW_PINV 0x{gw.PINV:08x}u" in text
    assert f"#define FPW_PTOP1 0x{gw.PTOP1:08x}u" in text
    table = re.search(r"#define FPW_CORR_TABLE (.*)", text).group(1)
    rows = re.findall(r"\{([^{}]*)\}", table)
    assert [sum(int(w.strip()[:-1], 16) << (32 * k)
                for k, w in enumerate(r.split(","))) for r in rows] == \
        list(gw.CORR)
    # Only the G2 library's build carries them: no field's plan header.
    for spec in kernels.all_specs():
        assert "FPW_" not in kernels.plan_header(spec)
    assert kernels.lib_header("fq_mul") is None


def _limbs(v):
    return [(v >> (10 * i)) & 1023 for i in range(gw.LIMBS)]


@pytest.mark.parametrize("kind", ["loose_bound", "random", "zero", "p",
                                  "top_limb"])
def test_entry_keeps_the_residue_below_2_381(kind):
    rng = np.random.default_rng(7)
    limbs = {"loose_bound": [gw.LOOSE_MAX] * gw.LIMBS,
             "random": rng.integers(0, gw.LOOSE_MAX + 1, gw.LIMBS).tolist(),
             "zero": [0] * gw.LIMBS, "p": _limbs(P),
             "top_limb": [0] * (gw.LIMBS - 1) + [gw.LOOSE_MAX]}[kind]
    value = sum(x << (10 * i) for i, x in enumerate(limbs))
    x = gw.entry(limbs)
    assert x % P == value % P and 0 <= x < 1 << 381
    with pytest.raises(ValueError):
        gw.entry(limbs[:-1] + [gw.LOOSE_MAX + 1])


def test_quotient_step_at_its_extremes():
    shift = 352
    for v in (0, P - 1, P, LOOSE_TOP, 34 * (1 << 381) - 1,
              ((gw.PTOP1 * 40) << shift) - 1, (gw.PTOP1 * 40) << shift):
        r = gw.reduce13(v)
        assert r % P == v % P
        q = (v >> shift) // gw.PTOP1
        assert 0 <= r < (gw.PTOP1 + q) << shift <= 1 << 381
    with pytest.raises(OverflowError):  # a quotient beyond one word
        gw.reduce13((1 << 416) - 1)


def test_exit_splits_into_10_bit_limbs():
    rng = np.random.default_rng(9)
    for y in [0, (1 << 384) - 1, 2 * P - 1] + [
            int.from_bytes(rng.bytes(48), "little") for _ in range(20)]:
        limbs = gw.exit_limbs(y)
        assert len(limbs) == gw.LIMBS and max(limbs) < 1024
        assert sum(x << (10 * i) for i, x in enumerate(limbs)) == y


def test_redc_on_extreme_accumulators():
    R = 1 << 384
    rinv = pow(R, -1, P)
    top = (1 << 768) - (R - 1) * P - 1  # the largest sum REDC takes
    rng = np.random.default_rng(11)
    for d in [0, 1, P, top] + [
            int.from_bytes(rng.bytes(95), "little") for _ in range(20)]:
        r = gw.redc(d)
        assert r == (d + ((-d * pow(P, -1, R)) % R) * P) // R
        assert r % P == d * rinv % P and r < 1 << 384
    with pytest.raises(OverflowError):
        gw.redc(top + P * R)


@pytest.mark.parametrize("prog", gw.PROGRAMS, ids=lambda p: p.name)
def test_bounds_hold_for_every_loose_input(prog):
    """Interval arithmetic on the tables: the invariants the kernels'
    source states."""
    b = gw.bounds(prog)
    assert b["entry"] < 1 << 381 and b["lin"] < 1 << 381
    assert b["stage1"] < 1 << 382
    assert b["sum"] < 1 << 384
    assert b["output"] < 2 * P


def _g2_lanes(kind, lanes, seed):
    """(P, Q) as (lanes, 2, 39) int32 coordinates: points with identities
    and a doubling lane, random loose limbs, or every limb at 4095."""
    rng = np.random.default_rng(seed)
    if kind == "points":
        pts = [oracle.g2_mul(oracle.G2_GEN, int(rng.integers(1, 2**40)))
               for _ in range(lanes)]
        p_aff = pts[:-1] + [None]
        q_aff = pts[::-1]
        q_aff[1] = None
        q_aff[2] = p_aff[2]  # P + P
        return (tuple(dev.g2_from_oracle(p_aff)),
                tuple(dev.g2_from_oracle(q_aff)))
    shape = (lanes, 2, dev.FQ.n)
    make = ((lambda: torch.full(shape, gw.LOOSE_MAX, dtype=torch.int32))
            if kind == "loose_bound" else
            (lambda: torch.from_numpy(rng.integers(
                0, gw.LOOSE_MAX + 1, shape, dtype=np.int32))))
    return tuple(make() for _ in range(3)), tuple(make() for _ in range(3))


@pytest.mark.parametrize("kind", ["points", "random", "loose_bound"])
@pytest.mark.parametrize("prog", gw.PROGRAMS, ids=lambda p: p.name)
def test_programs_match_the_plain_group_law(prog, kind):
    """The integer model of a kernel, lane by lane, gives the plain
    formulas' field elements (G2.add_plain / dbl_plain, canonical), as a
    10-bit split of a value below 2p."""
    lanes = 4
    p, q = _g2_lanes(kind, lanes, seed=len(kind))
    if prog is gw.ADD:
        ins = p + q
        want = dev.G2.add_plain(dev.Point(*p), dev.Point(*q))
    else:
        ins = p
        want = dev.G2.dbl_plain(dev.Point(*p))
    want = [dev.FQ.to_ints(c) for c in want]  # (lane, component) order
    for lane in range(lanes):
        out = gw.run(prog, [ins[c][lane, k].tolist()
                            for c in range(len(ins)) for k in (0, 1)])
        for i, limbs in enumerate(out):
            value = sum(x << (10 * j) for j, x in enumerate(limbs))
            assert max(limbs) < 1024 and value < 2 * P
            assert value % P == want[i // 2][2 * lane + i % 2]


def test_programs_read_only_values_of_earlier_phases():
    """A phase's jobs are independent (they run on different warps
    between two block barriers): none reads a slot its own phase
    writes, and every slot read holds a value written earlier."""
    for prog in gw.PROGRAMS:
        written = {dst for dst, _ in prog.load}
        for phase in (prog.mul, prog.lin1, prog.lin2):
            reads = ({s for j in phase for a, b, _ in j.terms for s in (a, b)}
                     if phase is prog.mul else
                     {s for j in phase for s in (j.a, j.b) if s >= 0})
            dsts = {j.dst for j in phase}
            assert reads <= written and not reads & dsts
            written |= dsts
        assert {s for j in prog.out for a, b, _ in j.terms
                for s in (a, b)} <= written
        assert sorted(j.dst for j in prog.out) == list(range(6))

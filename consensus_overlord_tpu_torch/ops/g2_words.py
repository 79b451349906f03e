"""The word design of csrc/g2_point.cu: BLS12-381's Fq as 12 words of 32
bits, the constants and per-lane programs the G2 kernels are built with,
an integer model of every step, and the count of its instructions.

Representation.  Inside the kernels an Fq element is 12 little-endian
32-bit words (csrc/fp381_words.cuh), carried with the card's carry flag.
A product is a Montgomery reduction (REDC) of a 24-word sum of word
products: REDC(D) = D·R⁻¹ mod p with R = 2³⁸⁴, computed from the bottom
word up as D + m·p·2³²ⁱ, m = dᵢ·(−p⁻¹) mod 2³², so no division enters.

No conversion into Montgomery form.  Inputs enter as they are (the loose
limbs repacked into words and reduced by one quotient step), so a first
product carries R⁻¹, and a product of two such values R⁻³.  Renes–
Costello–Batina's Algorithm 7 (a = 0) and Algorithm 9 are homogeneous
of that shape: every output coordinate is a sum of products of two
stage-1 values (each itself a product of inputs), and the additions,
subtractions and small multiples between leave the scale alone.  So each
output comes out as its true value times R⁻³, and one more product, by
R⁴ mod p (2R⁴ where Algorithm 9 doubles x3), restores it: 6 products a
kernel instead of the 18 (add) or 12 (doubling) that entering and
leaving Montgomery form would take.

Lazy sums.  A job sums up to four word products before one REDC: each
output Fq component of an Fq2 product is a0b0 − a1b1 or a0b1 + a1b0
(schoolbook, so no Karatsuba sum has to cross threads), and a sum or
difference of two Fq2 products is four terms.  A negative term a·b is
a·(2p − b), so the accumulator never goes below zero.

Programs.  Each kernel is five phases over one lane's slots of 12 words
in shared memory, with a block barrier between phases: LOAD (entry of
the input coordinates), MUL (stage-1 values), LIN twice (the linear
glue: k·(a ± m·b), each ending in a quotient step), OUT (the output
components: the sums, the correction product, the exit to 10-bit
limbs).  The jobs of a phase are independent and run round-robin on
the warps of the lane's block, all 32 threads of a warp on one job for
32 lanes.  The tables below are generated into the build's header
(`header_text`), and `run` replays them on Python integers with every
bound of the words checked, so the CPU tests hold the same tables the
card runs against the plain formulas.

Invariants (checked for all inputs by `bounds`, and step by step by
`run`): an entered value and every LIN output are below 2³⁸¹ (one
quotient step q = ⌊v / 2³⁵² / (p_top + 1)⌋ leaves v − q·p below
(p_top + q + 1)·2³⁵²); a stage-1 value is below 2³⁸²; every accumulator
stays below 2⁷⁶⁸ (24 words), every REDC output below 2³⁸⁴ (12 words), and
an output, below 2p, splits into 39 limbs of 10 bits (each < 1024).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .field import BLS12_381_P

P = BLS12_381_P
WORDS = 12
WORD_BITS = 32
MASK = (1 << WORD_BITS) - 1
R = 1 << (WORD_BITS * WORDS)
#: −p⁻¹ mod 2³²: REDC's per-word multiplier.
PINV = (-pow(P, -1, 1 << WORD_BITS)) & MASK
#: p's top word + 1: the divisor of the quotient step.
PTOP1 = (P >> (WORD_BITS * (WORDS - 1))) + 1
#: The multiples of p a negation subtracts from, by a table's neg field
#: (0: no negation).
NEG = (0, 2 * P, 4 * P)
#: The output products' constants, by an OUT job's corr field: R⁴ and
#: 2R⁴ mod p (x3 of the doubling is 2·U·XY).
CORR = (pow(R, 4, P), 2 * pow(R, 4, P) % P)
LIMBS = 39
LIMB_BITS = 10
LOOSE_MAX = (1 << (LIMB_BITS + 2)) - 1
#: Terms a MUL or OUT job sums at most.
MAX_TERMS = 4


class Job(NamedTuple):
    """A MUL or OUT job: REDC(Σ a·b) of up to MAX_TERMS terms (a, b, neg:
    b replaced by NEG[neg] − b), into slot `dst` (MUL) or, times
    CORR[corr] and split into limbs, into output component `dst` =
    coordinate·2 + component (OUT)."""
    dst: int
    corr: int
    terms: Tuple[Tuple[int, int, int], ...]


class Lin(NamedTuple):
    """A LIN job: slot dst = reduce(k·(a + t)), t = 0 (b < 0), m·b or
    NEG[neg] − m·b."""
    dst: int
    a: int
    b: int
    m: int
    neg: int
    k: int


class Program(NamedTuple):
    name: str
    slots: int                         # Fq slots of a lane
    load: Tuple[Tuple[int, int], ...]  # (dst slot, coordinate·2 + component)
    mul: Tuple[Job, ...]
    lin1: Tuple[Lin, ...]
    lin2: Tuple[Lin, ...]
    out: Tuple[Job, ...]


def _fq2(name: str) -> Tuple[str, str]:
    return (f"{name}.0", f"{name}.1")


def _fq2_mul(a, b, sign: int = 1):
    """The terms of c0 and c1 of sign·a·b over Fq2 = Fq[u]/(u² + 1):
    c0 = a0b0 − a1b1, c1 = a0b1 + a1b0; a negative term negates its b."""
    n = 1 if sign < 0 else 0
    return ([(a[0], b[0], n), (a[1], b[1], 1 - n)],
            [(a[0], b[1], n), (a[1], b[0], n)])


def _sum(*products):
    return tuple(sum((list(p[c]) for p in products), []) for c in (0, 1))


def _build(name: str, coords: Sequence[str], muls, lin1, lin2,
           outs) -> Program:
    """Allocate slots (a slot is free again in the phase after its value's
    last read) and number the tables.  muls: [(value, terms)]; lin1,
    lin2: [(value, a, b or None, m, neg, k)]; outs: [(component, corr,
    terms)] in output order."""
    phases = [[(c, ()) for c in coords],
              [(v, [t[:2] for t in terms]) for v, terms in muls],
              [(v, [a] + ([b] if b else [])) for v, a, b, *_ in lin1],
              [(v, [a] + ([b] if b else [])) for v, a, b, *_ in lin2],
              [(None, [t[:2] for t in terms]) for _, _, terms in outs]]
    last: Dict[str, int] = {}
    for ph, jobs in enumerate(phases):
        for _, reads in jobs:
            for pair in reads:
                for v in (pair if isinstance(pair, tuple) else (pair,)):
                    last[v] = ph
    slot: Dict[str, int] = {}
    owner: List[str] = []
    for ph, jobs in enumerate(phases):
        for v, _ in jobs:
            if v is None:
                continue
            free = [s for s, o in enumerate(owner) if last.get(o, -1) < ph]
            if free:
                slot[v] = free[0]
                owner[free[0]] = v
            else:
                slot[v] = len(owner)
                owner.append(v)
    job = lambda dst, corr, terms: Job(dst, corr, tuple(  # noqa: E731
        (slot[a], slot[b], n) for a, b, n in terms))
    lin = lambda v, a, b, m, neg, k: Lin(  # noqa: E731
        slot[v], slot[a], slot[b] if b else -1, m, neg, k)
    return Program(
        name, len(owner),
        tuple((slot[c], i) for i, c in enumerate(coords)),
        tuple(job(slot[v], 0, terms) for v, terms in muls),
        tuple(lin(*j) for j in lin1), tuple(lin(*j) for j in lin2),
        tuple(job(dst, corr, terms) for dst, corr, terms in outs))


def _jobs(name: str, pair) -> List:
    return [(f"{name}.{c}", pair[c]) for c in (0, 1)]


def _outs(coord: int, corr: int, pair) -> List:
    return [(2 * coord + c, corr, pair[c]) for c in (0, 1)]


def _add_program() -> Program:
    """RCB Algorithm 7 (a = 0), 3b = 12(1 + u), as ops/curve.py CurveOps.add:
    x3 = t3·t1' − t4·y3', y3 = t1'·z3' + y3'·3t0, z3 = t4·z3' + t3·3t0 with
    t0 = X1X2, t1 = Y1Y2, t2 = Z1Z2, t3 = X1Y2 + Y1X2, t4 = Y1Z2 + Z1Y2,
    y3' = 3b(X1Z2 + Z1X2), t1' = t1 − 3b·t2, z3' = t1 + 3b·t2.  The
    four-term jobs first, so that each warp of six gets one of each."""
    X1, Y1, Z1, X2, Y2, Z2 = (_fq2(c) for c in
                              ("X1", "Y1", "Z1", "X2", "Y2", "Z2"))
    muls = (_jobs("t3", _sum(_fq2_mul(X1, Y2), _fq2_mul(Y1, X2)))
            + _jobs("t4", _sum(_fq2_mul(Y1, Z2), _fq2_mul(Z1, Y2)))
            + _jobs("w", _sum(_fq2_mul(X1, Z2), _fq2_mul(Z1, X2)))
            + _jobs("t0", _fq2_mul(X1, X2)) + _jobs("t1", _fq2_mul(Y1, Y2))
            + _jobs("t2", _fq2_mul(Z1, Z2)))
    # 3b·v = 12(v0 − v1) + 12(v0 + v1)u
    lin1 = [("b3t2.0", "t2.0", "t2.1", 1, 1, 12),
            ("b3t2.1", "t2.0", "t2.1", 1, 0, 12),
            ("y3.0", "w.0", "w.1", 1, 1, 12), ("y3.1", "w.0", "w.1", 1, 0, 12),
            ("s0.0", "t0.0", None, 0, 0, 3), ("s0.1", "t0.1", None, 0, 0, 3)]
    lin2 = [(f"{v}.{c}", f"t1.{c}", f"b3t2.{c}", 1, neg, 1)
            for c in (0, 1) for v, neg in (("T1", 1), ("Z3", 0))]
    t3, t4, T1, Z3, y3, s0 = (_fq2(v) for v in
                              ("t3", "t4", "T1", "Z3", "y3", "s0"))
    outs = (_outs(0, 0, _sum(_fq2_mul(t3, T1), _fq2_mul(t4, y3, -1)))
            + _outs(1, 0, _sum(_fq2_mul(T1, Z3), _fq2_mul(y3, s0)))
            + _outs(2, 0, _sum(_fq2_mul(t4, Z3), _fq2_mul(t3, s0))))
    return _build("g2_add", X1 + Y1 + Z1 + X2 + Y2 + Z2, muls, lin1, lin2,
                  outs)


def _dbl_program() -> Program:
    """RCB Algorithm 9 (a = 0), as ops/curve.py CurveOps.dbl:
    x3 = 2·XY·U, y3 = V·U + S·W, z3 = YZ·S with W = 3b·Z², S = 8Y²,
    U = Y² − 3W, V = Y² + W."""
    X, Y, Z = (_fq2(c) for c in ("X", "Y", "Z"))
    muls = (_jobs("YY", _fq2_mul(Y, Y)) + _jobs("YZ", _fq2_mul(Y, Z))
            + _jobs("ZZ", _fq2_mul(Z, Z)) + _jobs("XY", _fq2_mul(X, Y)))
    lin1 = [("W.0", "ZZ.0", "ZZ.1", 1, 1, 12), ("W.1", "ZZ.0", "ZZ.1", 1, 0, 12),
            ("S.0", "YY.0", None, 0, 0, 8), ("S.1", "YY.1", None, 0, 0, 8)]
    lin2 = [(f"{v}.{c}", f"YY.{c}", f"W.{c}", m, neg, 1)
            for c in (0, 1) for v, m, neg in (("U", 3, 2), ("V", 1, 0))]
    XY, YZ, U, V, S, W = (_fq2(v) for v in ("XY", "YZ", "U", "V", "S", "W"))
    outs = (_outs(0, 1, _fq2_mul(XY, U))
            + _outs(1, 0, _sum(_fq2_mul(V, U), _fq2_mul(S, W)))
            + _outs(2, 0, _fq2_mul(YZ, S)))
    return _build("g2_dbl", X + Y + Z, muls, lin1, lin2, outs)


ADD = _add_program()
DBL = _dbl_program()
PROGRAMS = (ADD, DBL)


# -- the generated header ----------------------------------------------------

def _words(v: int) -> List[int]:
    return [(v >> (WORD_BITS * k)) & MASK for k in range(WORDS)]


def _c_list(vals) -> str:
    return "{" + ", ".join(str(v) for v in vals) + "}"


def _hex_words(v: int) -> str:
    return ", ".join(f"0x{w:08x}u" for w in _words(v))


def header_text() -> str:
    """The word constants and the two programs as C macros: the header
    g2_words.h that ops/kernels.py writes for the g2_point library alone.
    Tables are rows of ints: LOAD (dst, input), MUL/OUT (dst, nterms,
    corr, 0, then (a, b, neg) × MAX_TERMS), LIN (dst, a, b, m, neg, k,
    0, 0).  Deterministic."""
    out = ["// The word constants and programs of csrc/g2_point.cu, written",
           "// by ops/kernels.py from ops/g2_words.py at build time.  Do",
           "// not edit.", "#pragma once", f"#define FPW_GEN_WORDS {WORDS}"]
    for name, v in (("P", P), ("2P", 2 * P), ("4P", 4 * P)):
        out += [f"#define FPW_{name}_{k} 0x{w:08x}u"
                for k, w in enumerate(_words(v))]
    out += [f"#define FPW_PINV 0x{PINV:08x}u", f"#define FPW_PTOP1 0x{PTOP1:08x}u",
            f"#define FPW_NCORR {len(CORR)}",
            "#define FPW_CORR_TABLE {" + ", ".join(
                "{" + _hex_words(c) + "}" for c in CORR) + "}"]
    for prog in PROGRAMS:
        tag = "G2W_" + prog.name[3:].upper()
        jobs = lambda js: [  # noqa: E731
            [j.dst, len(j.terms), j.corr, 0] + [x for t in j.terms for x in t]
            + [0] * 3 * (MAX_TERMS - len(j.terms)) for j in js]
        tables = {"LOAD": [list(x) for x in prog.load], "MUL": jobs(prog.mul),
                  "LIN": [list(j) + [0, 0] for j in prog.lin1 + prog.lin2],
                  "OUT": jobs(prog.out)}
        out += [f"#define {tag}_SLOTS {prog.slots}",
                f"#define {tag}_LOADS {len(prog.load)}",
                f"#define {tag}_MULS {len(prog.mul)}",
                f"#define {tag}_LIN1 {len(prog.lin1)}",
                f"#define {tag}_LIN2 {len(prog.lin2)}",
                f"#define {tag}_OUTS {len(prog.out)}"]
        out += [f"#define {tag}_{k}_TABLE " + _c_list(_c_list(r) for r in rows)
                for k, rows in tables.items()]
    return "\n".join(out) + "\n"


# -- the integer model ---------------------------------------------------------

def _fits(v: int, words: int, what: str) -> int:
    if not 0 <= v < 1 << (WORD_BITS * words):
        raise OverflowError(f"{what}: {v} does not fit {words} words")
    return v


def entry(limbs: Sequence[int]) -> int:
    """Loose limbs → 13 words (the repack), then one quotient step."""
    if len(limbs) != LIMBS or not all(0 <= int(x) <= LOOSE_MAX
                                      for x in limbs):
        raise ValueError("entry takes 39 loose limbs")
    v = sum(int(x) << (LIMB_BITS * i) for i, x in enumerate(limbs))
    return reduce13(_fits(v, WORDS + 1, "entry"))


def reduce13(v: int) -> int:
    """A 13-word value minus q·p, q = ⌊(v >> 352) / (p_top + 1)⌋ (a 64-bit
    quotient of the top two words), kept in 12 words."""
    _fits(v, WORDS + 1, "quotient step input")
    q = _fits((v >> (WORD_BITS * (WORDS - 1))) // PTOP1, 1, "quotient")
    return _fits(v - q * P, WORDS, "quotient step output")


def redc(d: int) -> int:
    """D·R⁻¹ mod p as the kernel computes it: 12 word steps on a 24-word
    accumulator, each adding m·p·2³²ⁱ."""
    _fits(d, 2 * WORDS, "accumulator")
    for i in range(WORDS):
        m = ((d >> (WORD_BITS * i)) & MASK) * PINV & MASK
        d = _fits(d + (m * P << (WORD_BITS * i)), 2 * WORDS, "REDC")
    assert d & (R - 1) == 0
    return _fits(d >> (WORD_BITS * WORDS), WORDS, "REDC output")


def exit_limbs(y: int) -> List[int]:
    """12 words → 39 limbs of 10 bits."""
    _fits(y, WORDS, "exit")
    return [(y >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1)
            for i in range(LIMBS)]


def _terms(slots: Dict[int, int], terms) -> int:
    d = 0
    for a, b, neg in terms:
        x = _fits(NEG[neg] - slots[b], WORDS, "negation") if neg else slots[b]
        d = _fits(d + slots[a] * x, 2 * WORDS, "accumulator")
    return redc(d)


def _lin(slots: Dict[int, int], j: Lin) -> int:
    t = 0 if j.b < 0 else _fits(j.m * slots[j.b], WORDS, "m·b")
    if j.neg:
        t = _fits(NEG[j.neg] - t, WORDS, "negation")
    s = _fits(slots[j.a] + t, WORDS, "sum")
    return reduce13(_fits(j.k * s, WORDS + 1, "k·sum"))


def run(prog: Program, inputs: Sequence[Sequence[int]]) -> List[List[int]]:
    """One lane of the kernel on Python integers: inputs[c·2 + k] the
    39 loose limbs of coordinate c's component k; returns the output
    components' limbs in the same order.  Raises OverflowError where a
    value would leave its words."""
    slots: Dict[int, int] = {}
    for dst, src in prog.load:
        slots[dst] = entry(inputs[src])
    stage = {j.dst: _terms(slots, j.terms) for j in prog.mul}
    slots.update(stage)
    for lin in (prog.lin1, prog.lin2):
        slots.update({j.dst: _lin(slots, j) for j in lin})
    out = [None] * len(prog.out)
    for j in prog.out:
        y = _terms(slots, j.terms)
        out[j.dst] = exit_limbs(redc(_fits(y * CORR[j.corr], 2 * WORDS,
                                           "correction")))
    return out


def _reduce13_max(vmax: int) -> int:
    """The largest quotient-step output over inputs 0..vmax."""
    shift = WORD_BITS * (WORDS - 1)
    top = vmax >> shift
    best = 0
    for q in range(top // PTOP1 + 1):
        hi = min(top, (q + 1) * PTOP1 - 1)  # the largest top with quotient q
        v = min(vmax, ((hi + 1) << shift) - 1)
        best = max(best, v - q * P)
    return best


def _redc_max(dmax: int) -> int:
    _fits(dmax + (R - 1) * P, 2 * WORDS, "REDC bound")
    return (dmax + (R - 1) * P) // R


def bounds(prog: Program) -> Dict[str, int]:
    """Upper bounds of every value of the program over all loose inputs,
    by interval arithmetic on the tables; raises OverflowError where one
    could leave its words.  Returns the largest value of each kind."""
    loose = sum(LOOSE_MAX << (LIMB_BITS * i) for i in range(LIMBS))
    hi = {dst: _reduce13_max(_fits(loose, WORDS + 1, "entry"))
          for dst, _ in prog.load}
    out = {"entry": max(hi.values())}

    def terms(ts) -> int:
        d = sum(hi[a] * (NEG[n] if n else hi[b]) for a, b, n in ts)
        for _, b, n in ts:
            if n and hi[b] > NEG[n]:
                raise OverflowError("a negation could go below zero")
        return _redc_max(_fits(d, 2 * WORDS, "accumulator bound"))

    stage = {j.dst: terms(j.terms) for j in prog.mul}
    hi.update(stage)
    out["stage1"] = max(stage.values())
    for lin in (prog.lin1, prog.lin2):
        got = {}
        for j in lin:
            t = 0 if j.b < 0 else j.m * hi[j.b]
            if j.neg:
                if t > NEG[j.neg]:
                    raise OverflowError("a negation could go below zero")
                t = NEG[j.neg]
            s = _fits(hi[j.a] + t, WORDS, "sum bound")
            got[j.dst] = _reduce13_max(_fits(j.k * s, WORDS + 1, "k·sum"))
        hi.update(got)
        out["lin"] = max(out.get("lin", 0), *got.values())
    sums = [terms(j.terms) for j in prog.out]
    out["sum"] = max(sums)
    out["output"] = _redc_max(_fits(max(sums) * max(CORR), 2 * WORDS,
                                    "correction bound"))
    return out


# -- instructions per lane -----------------------------------------------------

#: int32 instructions of each step as csrc/fp381_words.cuh writes them
#: (PTX), by pipe ("either": an op the compiler may issue on the IMAD or
#: the ALU pipe): a word row of a product, a chain of 12 mad.lo and one
#: of 12 mad.hi with 3 carry ops; a REDC word step, m = dᵢ·(−p⁻¹) and
#: the same row; a 12-word add or subtraction chain; a small multiple
#: (12 mul.lo, 12 mad.hi); the quotient step (the 64-bit quotient of a
#: constant divisor, counted as 8 multiplies and 6 ALU ops, then q·p and
#: a 13-word subtraction); the entry repack (a 64-bit shift-add a limb
#: and a carry pass a word); the exit (a shift pair and a mask a limb).
#: ptxas turns each mad.lo.cc and mad.hi.cc into an IMAD and an IADD3
#: that carries, so the card issues about twice the ALU ops counted
#: here.  step_ops(words, limbs) prices the same steps for a field of
#: another size (chip_smoke.py counts the G1 and field kernels' bounds
#: with it).
def step_ops(words: int = WORDS, limbs: int = LIMBS
             ) -> Dict[str, Dict[str, int]]:
    return {
        "row": {"imad": 2 * words, "alu": 3, "either": 0},
        "redc_step": {"imad": 2 * words + 1, "alu": 3, "either": 0},
        "chain": {"imad": 0, "alu": words, "either": 0},
        "small": {"imad": 2 * words, "alu": 0, "either": 0},
        "quotient": {"imad": 8 + 2 * words, "alu": 6 + words + 1,
                     "either": 0},
        "entry": {"imad": 0, "alu": 3 * limbs + 3 * words, "either": 0},
        "exit": {"imad": 0, "alu": 2 * limbs, "either": 0},
    }


STEP_OPS = step_ops()


def price_steps(steps: Dict[str, int],
              priced: Optional[Dict[str, Dict[str, int]]] = None
              ) -> Dict[str, int]:
    """int32 instructions of `steps` ({step: count}) by pipe, priced by
    STEP_OPS or `priced` (a step_ops table)."""
    priced = STEP_OPS if priced is None else priced
    return {k: sum(c * priced[s][k] for s, c in steps.items())
            for k in ("imad", "alu", "either")}


#: The Fq operations of the function itself: Renes–Costello–Batina's
#: Algorithm 7 (a = 0) and Algorithm 9 over Fq2 with each Fq2 product a
#: Karatsuba triple, as ops/curve.py CurveOps over ops/fq2.py Fq2Ops runs
#: them: products, additions and subtractions, small multiples.
FUNCTION_FQ_OPS = {"g2_add": {"mul": 36, "add": 62, "sub": 36, "small": 6},
                   "g2_dbl": {"mul": 24, "add": 29, "sub": 19, "small": 8}}


def bound_steps(prog: Program) -> Dict[str, int]:
    """The steps a lane needs at least, in this representation: a word
    product for each of the function's Fq products (FUNCTION_FQ_OPS) and
    for each output's scale correction; a REDC for each Fq value that is
    multiplied or output, as the program reduces them (lazy sums: one a
    stage-1 component, one an output sum, one a correction); a chain for
    each addition or subtraction and a small multiple for each by a
    constant, with no reduction after them; the entries, with their
    quotient steps, and the exits.  The program as written runs more:
    schoolbook Fq2 products (four word products, not three) and a
    quotient step after each LIN job."""
    f = FUNCTION_FQ_OPS[prog.name]
    return {
        "row": WORDS * (f["mul"] + len(prog.out)),
        "redc_step": WORDS * (len(prog.mul) + 2 * len(prog.out)),
        "chain": f["add"] + f["sub"],
        "small": f["small"],
        "quotient": len(prog.load),
        "entry": len(prog.load),
        "exit": len(prog.out),
    }


def bound_ops(prog: Program) -> Dict[str, int]:
    """int32 instructions a lane of the function needs at least, by pipe
    (bound_steps priced by STEP_OPS): what the kernels' bound counts."""
    return price_steps(bound_steps(prog))

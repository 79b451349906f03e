"""The build-time side of the port's CUDA kernels, on the CPU: the plan
header that ops/kernels.py generates from FieldSpec._plan, the build
path that hashes it, the lane group's split of the product terms, the
launch-size histogram, and chip_smoke.py's operation count and bound.  No GPU, no nvcc: nothing here builds."""

import re
from collections import Counter

import pytest

import chip_smoke
from consensus_overlord_tpu_torch import compile_cache
from consensus_overlord_tpu_torch.ops import kernels
from consensus_overlord_tpu_torch.ops.field import (BLS12_381_FQ as TFQ,
                                                    BLS12_381_P, ED25519_FQ,
                                                    FieldSpec, SECP256K1_FQ,
                                                    SM2_FQ)

_STEP = re.compile(r"FQ_STEP\((PAD|FOLD|CARRY), (\d+), (\d+), (\d+)\)")


def _header_plans(text):
    """Plan name → [(kind, arg, width before, width after)] parsed from
    the header's FQ_PLAN_<NAME>_STEPS X-macros."""
    plans = {}
    for block in text.split("#define FQ_PLAN_")[1:]:
        name = block.split("_STEPS", 1)[0].lower()
        plans[name] = [(k.lower(), int(a), int(wi), int(wo))
                       for k, a, wi, wo in _STEP.findall(block)]
    return plans


def test_plan_header_matches_field_plans_step_for_step():
    plans = _header_plans(kernels.plan_header(TFQ))
    assert list(plans) == list(kernels.PLAN_NAMES)
    for name in kernels.PLAN_NAMES:
        bounds = kernels.plan_bounds(TFQ, name)
        want = TFQ._plan(list(bounds))
        got = plans[name]
        assert [(k, a) for k, a, _, _ in got] == want, name
        width = len(bounds)
        for kind, arg, w_in, w_out in got:
            assert w_in == width
            width = TFQ.n if kind == "fold" else width + arg
            assert w_out == width <= kernels.max_width(TFQ)
        assert width == TFQ.n


def test_plan_header_is_deterministic():
    text = kernels.plan_header(TFQ)
    fresh = FieldSpec(BLS12_381_P, limb_bits=10, name=TFQ.name)
    assert kernels.plan_header(fresh) == text
    rows = max(a for steps in _header_plans(text).values()
               for k, a, _, _ in steps if k == "fold")
    assert f"#define FQ_GEN_FOLD_ROWS {rows}\n" in text


@pytest.mark.parametrize("spec", (ED25519_FQ, SECP256K1_FQ, SM2_FQ),
                         ids=lambda s: s.name)
def test_26_limb_specs_get_their_own_header_and_tables(spec):
    """Each 26-limb field passes the kernels' checks, and gets a header
    of its own limb count and plans (secp256k1 also its 3b = 21 plan for
    g1_point.cu), in its own build directory, and tables of its size."""
    text = kernels.plan_header(spec)
    assert "#define FQ_GEN_N 26\n" in text
    plans = _header_plans(text)
    assert list(plans) == list(kernels.plan_names(spec))
    for name, got in plans.items():
        bounds = kernels.plan_bounds(spec, name)
        assert [(k, a) for k, a, _, _ in got] == spec._plan(list(bounds))
        assert max(w for _, _, _, w in got) <= kernels.max_width(spec)
    b3 = kernels.G1_B3.get(spec.name)
    assert ("#define FQ_GEN_B3_PLAN FQ_PLAN_SMALL21\n" in text) == (b3 == 21)
    assert kernels.header_dir(spec) != kernels.header_dir(TFQ)
    assert text != kernels.plan_header(TFQ)
    tab = kernels.fq_tables(spec)
    assert tab.size == kernels.table_ints(spec) == 34 * 26 + 26
    for lib in kernels.spec_libs(spec):
        assert kernels._so_path(lib, text) != kernels._so_path(
            lib, kernels.plan_header(TFQ))


def test_so_path_follows_the_plan_header():
    text = kernels.plan_header(TFQ)
    for lib in ("fq_mul", "g1_point"):
        path = kernels._so_path(lib, text)
        assert kernels._so_path(lib, text) == path
        assert kernels._so_path(lib, text + "// edited\n") != path
        assert path.startswith(compile_cache.build_dir())


def test_so_path_follows_only_its_own_library_headers(monkeypatch):
    """The G2 word header (ops/g2_words.py) and the word core
    (csrc/fp381_words.cuh) name the g2_point build only: a change to
    either rebuilds g2_point and no other library."""
    text = kernels.plan_header(TFQ)
    before = {lib: kernels._so_path(lib, text) for lib in kernels._LIBS}
    name, g2_text = kernels.lib_header("g2_point")
    monkeypatch.setattr(kernels, "lib_header", lambda lib: (
        (name, g2_text + "// edited\n") if lib == "g2_point" else None))
    after = {lib: kernels._so_path(lib, text) for lib in kernels._LIBS}
    assert {lib for lib in before if before[lib] != after[lib]} == {
        "g2_point"}
    assert "fp381_words.cuh" not in kernels._HEADERS
    assert kernels._LIB_HEADERS == {"g2_point": (("fp381_words.cuh",),
                                                 "g2_words.h")}


@pytest.mark.parametrize("group", kernels.GROUP_SIZES)
def test_lane_group_terms_cover_every_term_once(group):
    _check_group_terms(group, TFQ)


@pytest.mark.parametrize("group", kernels.GROUP_SIZES)
def test_lane_group_terms_cover_every_term_once_at_26_limbs(group):
    _check_group_terms(group, ED25519_FQ)


def _check_group_terms(group, spec):
    n = spec.n
    L, W = kernels.group_layout(group, n)
    assert W >= n + 1 and 2 * W >= kernels.max_width(spec)
    threads = kernels.group_terms(group, n)
    assert len(threads) == group
    terms = Counter((i, j) for thread in threads for i, j, _ in thread)
    assert set(terms) == {(i, j) for i in range(n) for j in range(n)}
    assert set(terms.values()) == {1}  # every term exactly once
    for t, thread in enumerate(threads):
        assert all(col == i + j for i, j, col in thread)
        own = {t * L + s for s in range(L)} | {W + t * L + s
                                               for s in range(L)}
        assert {col for _, _, col in thread} <= own  # its own columns


def _word_ops(words, limbs, mul, stage1, chain, small, load, out):
    """The word rule of chip_smoke.word_ops, priced by hand: a row of 2w
    multiplies and 3 carry ops for each word of each product and scale
    correction, a REDC word step of 2w + 1 multiplies and 3 carry ops
    for each word of each first-stage product and twice each output, a
    w-word chain for each addition or subtraction, 2w multiplies for
    each small multiple, each load's quotient step and repack, each
    output's exit."""
    imad = (2 * words * words * (mul + out)
            + (2 * words + 1) * words * (stage1 + 2 * out)
            + (8 + 2 * words) * load + 2 * words * small)
    alu = (3 * words * (mul + out) + 3 * words * (stage1 + 2 * out)
           + words * chain + (7 + words) * load
           + (3 * limbs + 3 * words) * load + 2 * limbs * out)
    return {"imad": imad, "alu": alu, "either": 0}


def test_lane_ops_count_each_pipe():
    """chip_smoke.py's operation count.  The limb field ops (what the
    pairing kernels' bound counts): the product's 39² multiply-adds and
    every fold row's 39 on the multiply-add pipe, each carry pass's mask
    and shift-add on the ALU pipe.  The field and G1 kernels' bound: the
    least their function needs in 12 words of 32 bits (word_ops): one
    product (fq_mul), Algorithms 7 and 9 of Renes–Costello–Batina (12
    and 8 products, 6 and 4 of them in the first stage, 17 and 3
    additions or subtractions, 3 and 4 small multiples)."""
    def fold_imads(name):
        return TFQ.n * sum(a for k, a, _, _ in kernels.plan_steps(TFQ, name)
                           if k == "fold")

    mul_steps = kernels.plan_steps(TFQ, "mul")
    carried = sum(w for k, _, w, _ in mul_steps if k == "carry")
    f = chip_smoke.field_ops(TFQ)
    mul = TFQ.n * TFQ.n + fold_imads("mul")
    assert f["mul"] == {"imad": mul, "alu": f["mul"]["alu"], "either": 0}
    assert 2 * carried - len(mul_steps) <= f["mul"]["alu"] < 2 * (
        carried + len(mul_steps))
    assert f["small8"]["imad"] == fold_imads("small8")
    assert f["sub"]["either"] == TFQ.n  # one limb-wise op
    ops = chip_smoke.lane_ops(TFQ)
    assert ops["fq_mul"] == _word_ops(12, 39, 1, 0, 0, 0, 2, 1) == {
        "imad": 1240, "alu": 566, "either": 0}
    assert ops["g1_add"] == _word_ops(12, 39, 12, 6, 17, 3, 6, 3) == {
        "imad": 8184, "alu": 2442, "either": 0}
    assert ops["g1_dbl"] == _word_ops(12, 39, 8, 4, 3, 4, 3, 3) == {
        "imad": 6360, "alu": 1542, "either": 0}


def test_curve_lane_ops_count_each_kernel():
    """chip_smoke.py's operation count for the 26-limb kernels: ed_add
    (9 products, 5 adds and 4 subtractions) and wp_add_general (14
    products, 15 adds, 6 subtractions, 4 triples and 3 negations) from
    their limb field ops; each field's fq_mul and secp_add/secp_dbl from
    the least they need in 8 words (g1_add/g1_dbl's counts, 3b = 21)."""
    def plan_imads(spec, name):
        return spec.n * sum(a for k, a, _, _ in kernels.plan_steps(spec, name)
                            if k == "fold")

    for spec, fq_mul, want in (
            (ED25519_FQ, "fq_mul_ed25519",
             {"ed_add": (9, {"add2": 5, "sub": 4})}),
            (SM2_FQ, "fq_mul_sm2",
             {"wp_add_general": (14, {"add2": 15, "sub": 6, "small3": 4,
                                      "neg": 3})}),
            (SECP256K1_FQ, "fq_mul_secp256k1", {})):
        ops = chip_smoke.curve_lane_ops(spec)
        mul = spec.n * spec.n + plan_imads(spec, "mul")
        assert ops[fq_mul] == _word_ops(8, 26, 1, 0, 0, 0, 2, 1) == {
            "imad": 576, "alu": 382, "either": 0}
        for name, (muls, small) in want.items():
            assert ops[name]["imad"] == muls * mul + sum(
                c * plan_imads(spec, p) for p, c in small.items())
            assert ops[name]["either"] == sum(small.values()) * spec.n
    ops = chip_smoke.curve_lane_ops(SECP256K1_FQ)
    assert ops["secp_add"] == _word_ops(8, 26, 12, 6, 17, 3, 6, 3)
    assert ops["secp_dbl"] == _word_ops(8, 26, 8, 4, 3, 4, 3, 3)


@pytest.mark.parametrize("op", ["g2_add", "g2_dbl"])
def test_g2_lane_ops_count_the_plain_formulas(op):
    """The G2 kernels' bound starts from the Fq ops the function runs
    (ops/g2_words.py FUNCTION_FQ_OPS): the plain formulas' (CurveOps over
    Fq2Ops), tallied per element by a counting field on one lane."""
    import torch

    from consensus_overlord_tpu_torch.crypto import bls12381 as oracle
    from consensus_overlord_tpu_torch.ops import bls12381_groups as dev
    from consensus_overlord_tpu_torch.ops.curve import CurveOps
    from consensus_overlord_tpu_torch.ops.fq2 import Fq2Ops

    tally = Counter()

    class Counting:
        def __init__(self, spec):
            self._spec = spec

        def __getattr__(self, name):
            return getattr(self._spec, name)

        def _count(self, name, *xs):
            tally[name] += torch.broadcast_tensors(*xs)[0].numel() // TFQ.n

        def add(self, x, y):
            self._count("add", x, y)
            return self._spec.add(x, y)

        def sub(self, x, y):
            self._count("sub", x, y)
            return self._spec.sub(x, y)

        def mul(self, x, y):
            self._count("mul", x, y)
            return self._spec.mul_plain(x, y)

        def mul_small(self, x, k):
            self._count(f"small{k}", x)
            return self._spec.mul_small(x, k)

    f2 = Fq2Ops(Counting(TFQ))
    g2 = CurveOps(f2, lambda x: f2.mul_small_xi(x, 12), "counting")
    p = dev.g2_from_oracle([oracle.G2_GEN])
    g2.add(p, p) if op == "g2_add" else g2.dbl(p)
    from consensus_overlord_tpu_torch.ops import g2_words

    want = g2_words.FUNCTION_FQ_OPS[op]
    smalls = {k: c for k, c in tally.items() if k.startswith("small")}
    assert {k: c for k, c in tally.items() if k not in smalls} == {
        k: want[k] for k in ("mul", "add", "sub")}
    assert sum(smalls.values()) == want["small"]
    assert tally["mul"] == (36 if op == "g2_add" else 24)


@pytest.mark.parametrize("op, products, redcs, quotients, imad, alu", [
    ("g2_add", 42, 24, 12, 19824, 6084),
    ("g2_dbl", 30, 20, 6, 15024, 3876)])
def test_g2_lane_ops_count_the_word_programs(op, products, redcs, quotients,
                                             imad, alu):
    """chip_smoke.py's bound for the G2 kernels counts the least the
    function needs in words (ops/g2_words.py bound_ops): the Karatsuba
    Fq products and the six scale corrections (12 word rows each), a
    REDC for each reduced value of the program, the entries' quotient
    steps, priced per step as csrc/fp381_words.cuh writes them."""
    from consensus_overlord_tpu_torch.ops import g2_words

    prog = g2_words.ADD if op == "g2_add" else g2_words.DBL
    steps = g2_words.bound_steps(prog)
    assert steps["row"] == 12 * products
    assert steps["redc_step"] == 12 * redcs
    assert steps["quotient"] == quotients == len(prog.load)
    ops = chip_smoke.lane_ops(TFQ)[op]
    assert ops == g2_words.bound_ops(prog)
    assert (ops["imad"], ops["alu"], ops["either"]) == (imad, alu, 0)
    assert ops["imad"] == (24 * 12 * products + 25 * 12 * redcs
                           + 32 * quotients + 24 * steps["small"])


# (imad, alu, either) per lane, bytes in all, and the limit that binds.
_LIMITS = [((6400, 10, 0), 0, "imad"),
           ((10, 6400, 0), 0, "alu"),
           ((6400, 6400, 6400), 0, "issue"),
           ((1, 1, 1), 1e9, "bytes")]


@pytest.mark.parametrize("ops, nbytes, limit", _LIMITS,
                         ids=[lim for _, _, lim in _LIMITS])
def test_bound_takes_the_slowest_limit(ops, nbytes, limit):
    lanes, clock = 1000, 1.5e9
    per_sm = chip_smoke.SMS * clock
    want_s = {"imad": lanes * ops[0] / (chip_smoke.IMAD_PER_CLOCK_PER_SM
                                        * per_sm),
              "alu": lanes * ops[1] / (chip_smoke.ALU_PER_CLOCK_PER_SM
                                       * per_sm),
              "issue": lanes * sum(ops) / (chip_smoke.ISSUE_PER_CLOCK_PER_SM
                                           * per_sm),
              "bytes": nbytes / chip_smoke.HBM_BYTES_PER_S}
    ms, by = chip_smoke.bound(dict(zip(("imad", "alu", "either"), ops)),
                              lanes, nbytes, clock)
    assert ms == pytest.approx(max(want_s.values()) * 1e3, rel=1e-12)
    assert max(want_s, key=want_s.get) == limit
    assert by == ("bytes" if limit == "bytes" else "operations")


def test_launch_sizes_histogram():
    k = kernels.Kernel("probe", "nowhere.cu", "nowhere.py:1")
    for lanes in (1, 2, 3, 8192, 8192, 8193, 24576):
        k.count(lanes)
    assert k.launches == 7
    assert k.sizes == {1: 1, 2: 1, 3: 1, 8192: 2, 8193: 1, 24576: 1}
    assert kernels.size_buckets(k.sizes) == {1: 1, 2: 1, 4: 1, 8192: 2,
                                             16384: 1, 32768: 1}
    with pytest.raises(ValueError, match="lane groups"):
        kernels.group_layout(32, TFQ.n)
